#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one card.  It builds
the hand-written kernels from ``src/repro_torch/kernels/*/csrc`` (one
nvcc per source, sm_90a, all started together) and runs the phases below;
any failure exits non-zero.  Every training run of phases 3-5 gets a fresh
``--ckpt-dir`` under ``build/chip_smoke_ckpt`` (removed at the end), and
phases 3-3j and 4 fail if any run restarted (``restarts`` > 0): a retried
step could hide a kernel fault.

1. Kernels.  The comm_pack pack (B1) and unpack (B2) kernels against their
   plain PyTorch versions on the card — bit-identical — at the group
   shapes of the full-width main path and at ragged odd sizes, over wire
   {f32, bf16} x error feedback {off, on}; then their times (CUDA events,
   median), bytes, bound, the plain versions' times and one PyTorch call
   computing the same function where there is one (``torch.cat`` into the
   wire arena for the stateless pack, ``_foreach_copy_`` over views of
   the arena for unpack at scale 1; ``split_with_sizes_copy`` too on the
   groups whose outputs share the wire's dtype).
1b. Flash attention.  The forward (B3), dQ (B4) and dK/dV (B5) kernels
   (bf16: the tensor-core kernels of ``flash_sm90.cu``; f32: those of
   ``flash_attention.cu``) against their plain versions on the same CUDA
   tensors: at the main path's shape (B 4, S 512, 32 query / 4 KV heads,
   hd 64) in bf16 and f32, at every shape of the JAX package's flash tests
   (window, softcap, non-causal, G 1-8, hd 128/256), and with rows that
   see no key (checked against ``attention_ref``, exactly 0).
   Tolerances: o 2e-5 (f32) / 2e-2 (bf16) element by element and, for
   bf16, 1e-2 in per-row relative L2 over the head dim; lse 1e-5, f32
   gradients 2e-4, bf16 gradients 1e-2 x max|g|; for bf16 the largest max
   |diff| / max|want| of o, dq, dk and dv and the largest per-row relative
   L2 of o are printed beside the absolute figure.  A
   second run must give the same bits.  Then forward -> backward through
   the kernels' own (o, lse): dq, dk, dv of ``flash_attention_train`` on
   the card within 1e-2 x max|g| of the plain backward fed the plain
   forward's (o, lse).  Then each kernel's time per launch at the main
   path's shape (bf16), its plain version's, and
   ``F.scaled_dot_product_attention``'s forward and backward as yardsticks
   (dQ + dK/dV together against SDPA's backward, with the factor), and the
   device time (torch.profiler) and host time of a call of the forward and
   of the backward beside SDPA's.
1c. RG-LRU, and flash at RecurrentGemma's attention.  The recurrence
   kernels ``rglru_fwd`` (B6: a step kernel for T up to ``step_max_t()``,
   a tiled one past it) and ``rglru_bwd`` (its gradient) against their
   plain versions on the same CUDA tensors: at the three shapes of the JAX
   package's RG-LRU tests, the training shape (1, 4096, 4096), the prefill
   shape (1, 2304, 4096), the decode step's (4, 1 and 2, 4096), and T one
   below, at and one past the threshold, 255, 256, 257 and 300 at (B 1,
   W 40) and (B 4, W 4097); with and without h0: h / hT within 1e-5,
   gradients within 1e-5 x max(1, max|g|); hT exactly h[:, -1]; a second
   run gives the same bits; a run split at T/2, and one split at the
   threshold (step kernel, then tiled), threaded through hT -> h0 match one
   run; row b of a B 4 call has the bits of a B 1 call on that row (T 1 and
   300, forward and backward); the step kernel's h at T 1 and at the
   threshold is bitwise the first steps of the tiled kernel's.  Then each
   mode's time per launch, by CUDA events and by torch.profiler's device
   time, beside its bound and its plain version's: training forward and
   backward, prefill, and the decode step with ``torch.addcmul`` (at T 1
   the recurrence is one multiply-add) beside it, device time too (both
   are launch-bound); no other PyTorch call computes a linear recurrence.
   Then the forward's device time at the threshold (the step kernel) and
   one past it (the tiled one).  The flash kernels at RecurrentGemma's
   attention (B 1, S 4096, 16 query heads over 1 KV head, hd 256, causal,
   window 2048, bf16) against their plain versions (a second run of all three bitwise equal),
   forward -> backward through the kernels' own (o, lse) as in 1b, timed
   beside SDPA with the same window mask.
1d. WKV6.  The RWKV6 recurrence kernels ``wkv_fwd`` (B7) and ``wkv_bwd`` (its
   gradient) against their plain versions on the same CUDA tensors, at the
   four shapes of the JAX package's WKV tests and at the main path's
   (1, 4096, 64, 64), r/k/v in f32 and bf16, with and without s0 and
   ds_final: out / s_final within 2e-4 (+ 2e-4 relative), every gradient
   (dr, dk, dv, dw, du, ds0) within 2e-4 x max(1, max|g|); a strong-decay
   case (w in (0.05, 0.3), T 256); a run split at T/2 and threaded through
   s_final -> s0 matches one run; a second run gives the same bits.  The
   chunked forward (64-step chunks of 8-step sub-chunks) also alone, out /
   s_final at the same gate and a second run bitwise equal: at T below, at
   and past its boundaries (1, 8, 9, 15, 16, 63, 64, 65, 4096 + 17; K 64 bf16
   and K 32 f32 with s0), with w holding exact zeros and with chunks whose
   first 30 decays are 1e-30 (main path's shape; against the plain version in
   f64, with the f32 loop's and the chunked form's (``wkv_chunked_ref``)
   readings and the kernel's against the loop printed beside it), and a run
   split at T/2 +
   17, off the chunk grid, threaded through s_final -> s0; with w in
   (0.9999, 0.99999) at the same gate against the plain version in f64 (out
   and s_final at T 512 + 17, s_final at 4096 + 17: the f32 loop's own
   rounding is past the gate there, and its reading is printed); the
   largest forward reading, and the near-1 cases', are printed as shares of
   the gate.  The chunked backward also alone, all six gradients at the
   gradient gate, no value non-finite, a second run bitwise equal, the
   forward's chunk states handed over giving the same bits as those the
   call computes: at the main path's shape (bf16) with w 10^U(-12, -6), with
   1e-30 in steps 0-29 of every 64, with 30% exact zeros, and with w in
   (0.9999, 0.99999) against the plain version in f64; at T 1, 8, 9, 63, 64,
   65, 4096 + 17 (K 64 bf16 with s0 and ds_final, K 32 f32); the largest
   gradient reading is printed as a share of the gate, with where it
   occurred.  Then each kernel's
   time per call at the main path's shape (bf16 r/k/v, no s0 / ds_final,
   the backward given the forward's chunk states, as the path calls them;
   the backward also without them) beside its bound and its plain
   version's (no single PyTorch call computes the recurrence, so no library
   yardstick).  Both count their operations at the rate of 3xTF32 on the
   tensor cores, the path their products take (the f32 CUDA cores' figure
   is printed beside it).
1e. Flash at the new cells' attention.  The flash kernels (bf16) at each
   attention shape of phases 3d-3j (``NEW_ATTN``): StarCoder2-3B (B 1,
   S 4096, 24 query / 2 KV heads: G 12, hd 128), StarCoder2-7B (36 / 4:
   G 9), Gemma2-2B's local and global layers (S 8192, 8 / 4 heads, hd 256,
   softcap 50, window 4096 and none), Mixtral (S 8192, 32 / 8, hd 128,
   window 4096), DBRX (S 4096, 48 / 8, hd 128), MusicGen-large (S 4096,
   32 / 32: MHA, G 1, hd 64) and Qwen2-VL-2B (S 4096, 12 / 2: G 6, hd 128),
   causal: against their
   plain versions with phase 1b's tolerances, a second run bitwise equal,
   forward -> backward through the kernels' own (o, lse) as in 1b, then
   timed as in 1b beside their bounds and SDPA (with the window as a
   mask), or, at the softcap shapes, where SDPA computes no softcap,
   ``torch.compile(flex_attention)`` with a tanh ``score_mod``.
2. Reduced model.  Reduced tinyllama in fp32 with the flash kernels, loss
   and every gradient on the card against the same model on the CPU (the
   kernels' plain versions; loss rtol 1e-5, gradient max-abs <= 1e-4 x
   max|g|: other kernels, other summation orders).
2b. Reduced RecurrentGemma in fp32 (RG-LRU and local-attention layers, the
   tail, tied embeddings), the same comparison and tolerances, with the
   RG-LRU and flash launch counts checked on both sides.
2c. Reduced RWKV6 in fp32, the same comparison and tolerances, with the WKV
   launch counts checked on the card and the plain calls on the CPU.
2d. Reduced Gemma2, Mixtral, DBRX, MusicGen and Qwen2-VL in fp32 at seq
   128 (past the 64-key windows), the same comparison and tolerances; the
   MoE archs' loss holds the load-balance aux; MusicGen and Qwen2-VL train
   on embeds batches (their tables get no gradient on either side), with
   Qwen2-VL's head dim 24 raised to 32 and its M-RoPE sections to (4, 6, 6)
   on both sides (``kernel_head_dim``).  (Reduced StarCoder2 has head dim
   24, which the flash kernels do not take.)
3. Full-width training.  TinyLlama-1.1B, 22 layers, bf16 params,
   batch 4 x seq 512, ``--fuse arena --policy mg_wfbp --fabric gpu_nccl``
   on an NCCL world of 1, through ``repro_torch.launch.train.run``:
   ``post`` and ``dag`` with f32 wire (bitwise equal), ``post`` under
   ``remat='dots'`` (``overrides``; its 2D products saved, the rest
   recomputed: bitwise equal to ``post``, its step time and peak printed
   beside it), ``post`` with ``bf16_ef``, all with the flash kernels, then
   ``post --attn-impl plain``; 3 steps each from the same initial weights.
   Pack and unpack
   launches must each equal groups x steps, and ``issue()`` must run once
   per group per step; over the flash runs the forward kernel must launch
   2 x 22 times per step (activation checkpointing runs each layer's
   forward twice) and dQ and dK/dV 22 times each, with no plain call; the
   first-step losses of flash and plain must agree to 1e-2.
3b. Full-width RecurrentGemma-9B cut to 8 layers (2 stages of rec, rec,
   attn_local and the rec, rec tail; every width the published one), bf16
   params, batch 1 x seq 4096 (longer than the 2048 window), the same
   launcher flags, ``post``, ``post`` under ``remat='dots'`` (``DOTS_CELLS``)
   and ``dag`` with f32 wire, 3 steps each from the same weights: finite
   losses, ``dots`` and ``dag`` bitwise equal to ``post``, pack / unpack /
   ``issue()`` = groups x steps, and per step 12 ``rglru_fwd`` (6
   layers, each forward run twice under either checkpoint), 6 ``rglru_bwd``, 4
   flash forwards, 2 dQ and 2 dK/dV, with no plain call.  Then one
   ``probe_unit_times`` pass over the trained model (the stage probe runs
   B6, B3-B5): every unit covered, finite and > 0, its launches printed
   apart from the steps'.
3c. Full-width RWKV6-7B cut to 8 layers (every width the published one),
   bf16 params, batch 1 x seq 4096, the same launcher flags, ``post``,
   ``post`` under ``remat='dots'`` and ``dag`` with f32 wire, 3 steps each
   from the same weights: finite losses, ``dots`` and ``dag`` bitwise equal
   to ``post``, pack / unpack / ``issue()`` = groups x steps, and per step 16
   ``wkv_fwd`` (8 layers, each forward run twice under either checkpoint)
   and 8 ``wkv_bwd``, with no plain call.  Then one
   probe pass as in 3b (the stage probe runs B7).
3d-3j. The full-width cells of ``NEW_CELLS``, each through the launcher
   with phase 3b's flags, ``post`` and ``dag`` with f32 wire, 3 steps each
   from the same weights, each freed before the next: StarCoder2-3B (30
   layers, every one; B 1 x S 4096), StarCoder2-7B cut to 12 of 32 layers
   (S 4096), Gemma2-2B (26 layers; S 8192, so the 4096 window masks),
   Mixtral-8x7B cut to 2 of 32 layers (S 8192) and DBRX-132B cut to 1 of
   40 layers (S 4096, ``--optimizer sgd``: AdamW's state does not fit one
   card beside a 3.26 B-parameter layer), MusicGen-large (48 layers, every
   one; S 4096) and Qwen2-VL-2B (28 layers, every one; S 4096), the last two
   on (1, 4096, d) f32 embeds batches from the stream; 3d (``DOTS_CELLS``)
   also runs ``post`` under ``remat='dots'``.  Held as in 3b: finite
   losses, ``dag`` (and ``dots``) bitwise equal to ``post``, pack / unpack / ``issue()`` = groups
   x steps, per step flash fwd / dQ / dK-dV = 2 / 1 / 1 per attention layer
   and no RG-LRU or WKV launch, no plain call; at 3i and 3j the embedding
   table, which the loss never reads, ends each run with an exactly zero
   gradient (reduced through its group's all-reduce, as ``jax.grad`` gives
   it).  Printed: step time, peak memory beside the static bytes reckoned
   from the parameters, groups.
4. The measured-cost loop.  TinyLlama-1.1B as in phase 3, through
   ``run`` with ``--measure-comm --autotune --replan-every 4
   --replan-threshold 0.25 --comm-refit-every 4 --issue-order dag --steps
   8``: the startup sweep scored every policy of ``default_policies(24)``;
   the probes' unit seconds cover all 24 units, finite and > 0; the (α, β)
   fit at world 1 is finite and >= 0; every step's pack, unpack and
   ``issue()`` equal the groups of the plan it ran under, and flash fwd /
   dQ / dK-dV 44 / 22 / 22, with no plain call (the probes' and sweeps'
   launches printed apart); losses finite, the first three bitwise equal
   to phase 3's ``dag`` (at world 1 with f32 wire the grouping changes no
   arithmetic).  Printed: the fit, the startup sweep's candidates, each
   probe's seconds beside the TPU-v5e analytic ``t_b`` it replaces (ratio,
   nonuniformity) and its fwd+bwd wall and device time, the sweeps, the
   adopted plan, predicted against observed ``t_iter``, and the step time
   beside phase 3's ``dag``.  Then ``--dryrun 3 --trace-out
   build/phase4_trace.json.gz``: groups x 2 comm spans, backward spans, and
   the trace read back by ``parse_trace_spans``; the overlap report printed.
5. Checkpoint and restart.  TinyLlama-1.1B as in phase 3 with
   ``--compression bf16_ef --issue-order dag``, 5 AdamW steps, each run in
   a fresh directory: an unbroken run (``--ckpt-every 100``), then a broken
   one (``--ckpt-every 3 --max-restarts 1``) whose fault injector raises
   before step 4, so that the loop restores the checkpoint of step 3 and
   replays step 3.  Held: restarts 0 and 1; exactly one checkpoint,
   ``step_00000003``, holding ``plan.json``; the broken run's losses of
   steps 0-4 bitwise the unbroken run's, and its replayed step 3 its first;
   the final parameters, both AdamW moments, AdamW's step count and the EF
   residual bitwise equal (``torch.equal``); every step, the replayed one
   included, pack / unpack / ``issue()`` = groups and flash fwd / dQ /
   dK-dV 44 / 22 / 22, with no plain call.  Printed: the free disk before
   the phase, the checkpoint's bytes, the seconds of the synchronous
   snapshot, of the background write and of the restore, and step 3's
   first run (beside the background write) against the median of the
   others.  Then ``compressed_psum_rs_ag`` on a one-rank NCCL group,
   (32000, 2048) bf16 with an f32 residual: 3 ``issue()`` calls, sum and
   residual bitwise its plain version on the CPU.

6. Serving at full depth (``launch.serve.run``, random bf16 weights from
   seed 0, greedy, ``--fabric gpu_nccl``'s plan).  First the kernels in
   serving mode: ``rglru_fwd`` at (4, 1 and 2, 4096) with a nonzero h0
   (1e-5, hT == h[:, -1]), ``wkv_fwd`` at (4, 1, 64, 64) bf16 and f32 r/k/v
   with a nonzero s0 (2e-4 + 2e-4 relative), the flash kernels at prefill
   lengths of every cell with attention (6a, 6b, 6d-6j; phase 1b's checks),
   B7 and B3 (at each of those cells' longest prompt) timed in that mode
   beside their bounds (the flash forward beside SDPA, at 6h's softcap
   beside ``torch.compile(flex_attention)`` with a tanh ``score_mod``; B6
   is timed in phase 1c).  Then ten cells
   (``SERVE_CELLS``), each served twice on the same weights, once with the
   decode step captured in a CUDA graph and once eager: 6a TinyLlama-1.1B,
   22 layers, 8 slots / max_seq 1024, 16 requests of 64-512 prompt tokens
   x 128 new; 6b RecurrentGemma-9B, all 38 layers, 4 / 4096, 8 requests of
   256-2304 (the last exactly 2304: past the 2048 window, not a multiple
   of it) x 64; 6c RWKV6-7B, all 32 layers, 4 / 4096, 8 requests of
   256-2048 x 64; 6d MusicGen-large, all 48 layers, and 6e Qwen2-VL-2B, all
   28, each 8 / 1024 with 6a's 16 requests x 128, through the stub frontend
   (token ids become rows of the model's table, gathered inside the graph);
   6f StarCoder2-3B (all 30 layers), 6g StarCoder2-7B (all 32) and 6h
   Gemma2-2B (all 26: softcaps, alternating 4096 windows, the tied 256000
   x 2304 table), each 8 / 1024 with 6a's requests; 6i Mixtral-8x7B and 6j
   DBRX-132B unsharded, each at the deepest depth whose bf16 weights and
   f32 arena, reckoned on ``meta`` tensors before the run
   (``reckon_serve_bytes``), stay within 64 GB (``SERVE_STATIC_BUDGET``: a
   peak under 70 GB), 4 / 1024, 8 requests of 64-512 x 64 (at 4 slots a
   decode step's 4 tokens fit every expert's capacity, so no choice drops).
   Held: every request completes with its tokens, in the
   vocabulary; the captured step's tokens equal the eager step's for
   every request; the two equal-length requests batched give what each
   gives alone; one graph captured per engine, none after a join or a
   retirement; flash fwd = attention layers x prefills and no other flash
   launch, ``rglru_fwd`` / ``wkv_fwd`` = recurrent layers x (prefills +
   decode steps run in Python: the capture's warm-up and recording, eager
   steps), no backward kernel and no plain call on the card; every
   profiled decode step, captured and eager, ran by name in the device
   trace B6 once per RG-LRU layer, B7's two kernels once per RWKV6 layer
   and no flash forward (at 6c the captured step only), B6 as its step
   kernel and never its tiled one (captured steps at every cell, eager
   ones at ``SERVE_EAGER_PROFILE``'s); in 6b B6's launches inside the
   prefills (the wrapper's count read around each prefill) are the
   RG-LRU layers x the prefills, and the 2304-token prefill's device trace
   holds B6's tiled kernel once per RG-LRU layer and no step kernel; in 6b the
   2304-token request's prefill (``make_prefill_step``) and 16 greedy decode
   steps (``make_decode_step``): every window position held by a key of
   every windowed ring after each step, and each step's logits within 3e-3
   x max|logit| of the full forward; then the same steps from the prefill
   caches rewritten to the JAX prefill's ring layout, which must lack
   window positions at the first step (their logits' readings printed
   beside the aligned ones); in 6e the same 16 steps of the longest
   request against the full forward (no ring) on an f32 copy of the
   weights, with f32 caches, at the same gate, the bf16 model's readings
   printed beside it (bf16 rounding puts them near 2e-2, as reduced
   TinyLlama's and StarCoder2's in bf16), and so in 6h (softcaps and
   alternating windows in decode; every prompt inside the window); 6d's are
   not held to it: its
   decode step adds position 0's sinusoid, as the JAX engine's does.  Printed: prefill ms a request (median), decode step ms
   captured and eager, tokens/s, peak GB, the calibrated plan's predicted
   step against the observed one, each step's bound (weight bytes, the
   embedding table only when tied, plus the cache arena, at 3.35 TB/s),
   and a torch.profiler breakdown of a captured step (wall, device busy,
   idle share, ms by kernel class, the port's kernels by name, the five
   records that take the most time), at 6a, 6b, 6d, 6e and 6f of an eager
   one too; at 6b and 6h, whose tied table is f32, the device time of its
   cast to the bf16 head that every decode step runs.  Then
   the ten archs' reduced configs through the engine in f32 on the card
   (graph) and on the CPU (eager): greedy tokens equal over 8 steps, first
   logits within 1e-4 x max|logit| (reduced StarCoder2's and Qwen2-VL's head
   dim raised from 24 to 32 on both sides, ``kernel_head_dim``); and seeded
   sampling inside the graph repeats on its seed.

7. Resilient serving and the fleet at full width (random bf16 weights from
   seed 0, ``gpu_nccl``'s plan, the decode step one CUDA graph; snapshots
   under ``build/chip_smoke_snapshots``, removed at the end).  7a:
   TinyLlama-1.1B, 22 layers, through ``launch.serve.run`` with 6a's 16
   prompts (64-512 tokens) x 64 new, 8 slots / max_seq 1024, greedy,
   ``--snapshot-every 8`` and ``chaos=ChaosConfig(kill_every=12,
   max_kills=3, corrupt_snapshot_at=24, partial_write_at=36)``: every
   request's tokens equal the launcher's uninterrupted run's, 3 restarts,
   at least one fallback past the corrupted snapshot, one graph captured by
   the chaos engine across its restores, B3 = 22 x the prefills both
   engines counted and B6 / B7 none, no plain call or backward kernel.
   Then the snapshot's bytes and, median of 3 on the finished engine, the
   ms of its copy to the host, its write (CRC-32s and the atomic rename),
   its load and verification, and its restore into the graph's buffers
   (every state tensor keeps its storage); the loop's recovery seconds,
   with and without the backoff sleep.  Then 4 of the requests with
   ``--temperature 1.0`` (``gumbel_sampler``, seed 2) killed at steps 5 and
   17: the tokens equal the uninterrupted seeded run's.  7b: RecurrentGemma-
   9B, all 38 layers, 4 slots / max_seq 4096, 4 requests of 256-2304 prompt
   tokens (the last 2304) x 32, snapshots every 4 steps, killed at steps 9
   and 21: tokens equal the uninterrupted run's (the ``(conv, h)`` states,
   the rings and ``kpos`` restored); counts as 7a's with B6 = 26 x (prefills
   + decode steps in Python), B6 inside the prefills 26 x prefills; by name
   in the device trace a replay runs 26 B6 step kernels and no tiled one,
   a prefill 26 tiled kernels and no step kernel.  7c: 3 TinyLlama-1.1B
   replicas sharing one model, 4 slots / 1024 and one graph each, through
   ``launch.serve_fleet.run``: 24 requests of 128 prompt tokens x 32 at
   1e6 requests/s from seed 0, snapshots every 32 steps, replica 0 killed
   at its step 4 with ``--max-restores 0``, on a step clock (``StepClock``):
   1 death, failovers >= 1, 24 completed, 0 token mismatches, goodput 24 x
   32 tokens, every failed-over request finished on a live replica; B3 =
   22 x the prefills the replicas counted (fresh and resumed), no plain
   call; a second identical run gives the same tokens for every request.
   Then one fault-free run on the wall clock: p50 / p99 latency and goodput
   tokens/s, gated only on all 24 completing.  Fleet tokens are not held
   against a single engine's: the engine's shared ``kpos`` row makes a
   row's tokens depend on its batch (ROADMAP C).

8. Sharded serving (``ServingEngine(mesh=...)``, ``serving/sharded.py``) on
   one NCCL world of one card (a ``("model",)`` ``DeviceMesh``; its store
   under ``build/chip_smoke_pg``, removed at the end), random bf16 weights
   from seed 0, greedy, the f32 arena.  First B3 at Mixtral's serve shape
   (1, S, 32/8, hd 128, window 4096) at 8b's prefill lengths against its
   plain version (phase 1b's checks), and B3's forward timed at 6a's and
   8b's longest prefill beside its plain version, SDPA and its bound.
   8a: TinyLlama-1.1B x 22, 6a's 8 slots / 1024 and 16 prompts x 128, plans
   ``mg_wfbp`` and ``wfbp`` on ``gpu_nccl`` priced at ``{"model": 8}``
   (the deployment it would run) and executed on the one-rank group: the
   unsharded engine, then the sharded one captured (both plans) and eager
   (``mg_wfbp``).  Held: every request's tokens equal the unsharded
   engine's; one capture per engine; ``issue()`` = the plan's groups in the
   capture's warm-up run and again in its recording, none from the replays,
   the groups every eager step; B3 = 22 x 16 prefills a run, no other
   kernel and no plain call; by name in the device trace no B3 in a replay.
   Printed: the sharded and unsharded captured step ms side by side (what
   the mirror wire costs at world 1) and what each replay's collectives
   left in the trace, by name.  Then one coalesced all-reduce (the
   variadic wire) on the group: one ``issue()``.  8c: ``launch.serve.run(
   ... --sharded --measure-comm)`` at full depth, 6a's prompts x 32 (TP
   clamped from 8 to 1): the clamp, the ``sharded TP=1``, measured-fit,
   measured-fabric plan and per-group lines, tokens equal the unsharded
   launcher's; then ``install_plan`` of 8a's ``wfbp`` plan on its engine and
   a second round of the requests: a second capture, ``issue()`` = 2 x 22,
   tokens equal the unsharded engine's second round (the shared ``kpos``
   row carries over between rounds, ROADMAP C).  8b: Mixtral-8x7B at full
   width, 8 of 32 layers (23.7 GB in bf16; all 32 need 93 GB), 4 slots /
   1024, 8 requests of 71-445 prompt tokens x 32, ``wfbp`` on ``tpu_v5e``
   (its groups all-to-alls): the unsharded and the sharded engine, both
   captured, held as 8a's; printed as 8a's.

9. The what-if simulator on the card's measured costs (``repro_torch.sim``;
   host-side, no new model: it reuses phase 4's and 6a's measurements), then
   the simulate CLI and the examples.  9a: phase 4's startup probe (24 units
   of full-width TinyLlama-1.1B, backward seconds and the forward as the
   probe's remaining third) over ``lm_unit_costs``' bytes at 2048 tokens,
   ``MeasuredCosts.from_unit_times``, with phase 4's (α, β) fit and adopted
   plan: ``simulate_train_iteration`` equals ``core.timeline.evaluate`` bit
   for bit (t_iter, every group's start and end); the simulated t_iter is
   printed beside phase 4's predicted and observed.  9b: ``replay_train`` at
   8, 64 and 512 hosts on ``paper_10gbe`` and ``gpu_nccl`` with
   ``synceasgd``, ``wfbp``, ``mg_wfbp`` and ``dp_optimal`` on those costs:
   ``mg_wfbp``'s t_iter <= ``wfbp``'s and ``synceasgd``'s and
   ``dp_optimal``'s <= ``mg_wfbp``'s in every cell (ties within 1e-12 of
   each other, float summation order, count as ties); the ``SimReport``
   built twice byte-identical, its table printed and written to
   ``build/phase9_whatif.json``; mg_wfbp's merge sets beside the world-1
   fit's; stragglers at 64 hosts (spread 0 / 0.2 / 0.5, seed 3) monotone;
   64 -> 32 -> 64 hosts then 8 killed: 3 re-plans, 8 kills.  All of it is
   simulated from the card's unit costs and a fabric preset, not measured
   on 8, 64 or 512 hosts.  9c: ``replay_serve`` of 6a's 16 requests x 128
   tokens, 8 slots, at 6a's captured decode step: 16 completed, 0 lost,
   2048 tokens; two replicas with replica 0 killed mid-run: failovers >= 1,
   0 lost; the simulated decode tokens/s beside 6a's observed (the
   simulator prices no prefill).  9d: ``python -m
   repro_torch.launch.simulate --arch googlenet --sweep-hosts 8,64
   --calibrate --report-out build/phase9_cli.json`` in a subprocess: exit 0,
   both calibrations ok, the report read back; then, in this process,
   ``examples/torch_train_lm.py --tiny --steps 40`` on the card (the loss
   below 0.7x its start; every step pack = unpack = the plan's groups and
   flash fwd / dQ / dK-dV 8 / 4 / 4, no plain call),
   ``examples/torch_serve_decode.py`` (sharded tokens == unsharded) and
   ``examples/torch_elastic_restart.py`` (one restart, resumed tokens ==
   the unbroken run's), each one's seconds printed.

10. The dry run (``repro_torch.launch.dryrun``; host time, plus one rank's
   segment on the card).  10a: four cells through the CLI, each ``python
   -m repro_torch.launch.dryrun ... --fabric gpu_nccl`` in a subprocess on a
   fake process group, all started together: first TinyLlama-1.1B x
   train_4k x 16x16 at reduced widths and 2 layers, whose collectives by
   kind for the whole step and each segment (counted by the placement rule,
   whatever the torch version) must equal ``DRYRUN_REDUCED_COUNTS``, the
   counts ``tests/test_torch_dryrun.py`` pins; then TinyLlama-1.1B x
   train_4k x 16x16 (FSDP / DP, the train plan), the same under ``--remat
   dots`` (its flops a device less than the first's by exactly the 2·M·N·K
   of the products it saves, its peak no lower), DBRX-132B x decode_32k x
   16x16 (EP all-to-all, ``experts_only``, the serve plan) and
   RecurrentGemma-9B x long_500k x 2x16x16 (batch 1, sequence-sharded
   caches).  Gates: exit 0, each record read back with the JAX record's
   keys, ``peak_per_device_gib`` printed; its dominant term and the three
   roofline terms, its collectives by the op that required them, the
   roofline fraction and the plan's groups are printed.  10b, on the card meanwhile:
   one rank's TinyLlama train_4k stage segment (batch 1 x 4096, full width,
   plain attention, remat off) under ``FlopCounterMode`` must count exactly
   10a's per-device stage flops, and its ``max_memory_allocated`` must lie
   within 20% of ``MemTracker``'s peak for the same segment on fake CUDA
   tensors (``DRYRUN_MEM_TOL``: ATen's own copies inside CUDA kernels are
   not seen by a dispatch mode); the same stage under ``remat='dots'``
   must count on the card exactly the flops it counts on fake tensors, its
   ``max_memory_allocated`` within 20% of ``MemTracker``'s there; with
   ``attn_impl='flash'`` and ``remat='full'`` the segment launches B3 /
   B4 / B5 2 / 1 / 1 times at (1, 4096, 32/4, hd 64) and takes no plain
   call, and is timed beside its roofline term; the three kernels are held
   against their plain versions at that shape (1b's tolerances) and timed
   beside SDPA, a row of their own in the ``kernels`` line.  The records
   and logs go to ``build/phase10``.

The lines before the last are the card's name and power limit, the build
time, one line per phase result, and one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``.  The ``kernels`` line's
launches add up phases 3-3j and phases 4's and 5's training steps; it holds
the flash kernels once per configuration (TinyLlama, RecurrentGemma and
each ``NEW_ATTN`` shape, whose launches are its cell's: Gemma2's local and
global shapes share phase 3f's), and the serving path's B3 (6a, 6b, 6d-6j), B6
(6b: its decode steps, and its prefills, counted around each, in a row of
their own) and B7 (6c)
launches of the CUDA-graph runs in rows of their own, timed in serving
mode.  A CUDA graph's replay launches what its capture
recorded with no Python running, so a wrapper's count holds the capture's
recording and no replay; those rows add ``graph_replays`` (the run's
replays) and ``launches_per_replay`` (read by kernel name from the
device trace of profiled replays).  Phase 7 adds rows of its own: B3 over
7a's, 7a's sampled run's and 7c's runs (TinyLlama) and over 7b's
(RecurrentGemma), B6 inside 7b's prefills and in its decode steps run in
Python (with its replays), each timed as phase 6's row for the same shapes.
Phase 8 adds two B3 rows: its prefills at TinyLlama's serve shape (8a's
engines and 8c's launcher runs) and at Mixtral's (8b's), timed in phase 8.
B1 / B2 also count 9d's training example's launches; its flash launches, at
the reduced shape, are printed on phase 9's line and are no row's.  Phase
10b adds a B3-B5 row at (1, 4096, 32/4, hd 64), its launches those of one
flash segment run.
"""

from __future__ import annotations

import contextlib
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# dense bf16 and TF32 tensor cores; f32 CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
TRAIN_ARGS = [
    "--arch", "tinyllama-1.1b", "--steps", "3", "--batch", "4", "--seq", "512",
    "--fuse", "arena", "--policy", "mg_wfbp", "--fabric", "gpu_nccl",
]
PACK_SRC = "src/repro_torch/kernels/comm_pack/csrc/comm_pack.cu"
FLASH_SM90_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_sm90.cu"
RGLRU_SRC = "src/repro_torch/kernels/rglru/csrc/rglru.cu"
WKV_SRC = "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv.cu"
P4_ARGS = TRAIN_ARGS + [
    "--issue-order", "dag", "--measure-comm", "--autotune", "--replan-every", "4",
    "--replan-threshold", "0.25", "--comm-refit-every", "4", "--steps", "8",
]
TRACE_OUT = ROOT / "build" / "phase4_trace.json.gz"
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"  # every run's own --ckpt-dir, removed at the end
MAIN_ATTN = (4, 512, 32, 4, 64)  # B, S, Hq, Hkv, hd of one full-width layer
N_LAYERS = 22
RG_ARGS = [
    "--arch", "recurrentgemma-9b", "--steps", "3", "--batch", "1", "--seq", "4096",
    "--fuse", "arena", "--policy", "mg_wfbp", "--fabric", "gpu_nccl",
]
RG_DEPTH = {"n_layers": 8}  # 2 x (rec, rec, attn_local) + (rec, rec): 6 RG-LRU, 2 attention
RG_REC_LAYERS, RG_ATTN_LAYERS = 6, 2
MAIN_RGLRU = (1, 4096, 4096)  # B, T, lru_width of one full-width RG-LRU layer
PREFILL_RGLRU = (1, 2304, 4096)  # 6b's longest prefill, one RG-LRU layer
#: The JAX package's RG-LRU test shapes (tests/test_kernels.py): B, T, W.
JAX_RGLRU_SHAPES = [(2, 64, 128), (1, 128, 256), (1, 256, 512)]
RWKV_ARGS = [
    "--arch", "rwkv6-7b", "--steps", "3", "--batch", "1", "--seq", "4096",
    "--fuse", "arena", "--policy", "mg_wfbp", "--fabric", "gpu_nccl",
]
RWKV_LAYERS = 8  # the published 32 do not fit one card under AdamW (PERF.md)
MAIN_WKV = (1, 4096, 64, 64)  # B, T, heads, head size of one full-width RWKV6 layer
#: The JAX package's WKV test shapes (tests/test_kernels.py): B, T, H, K.
JAX_WKV_SHAPES = [(2, 64, 2, 32), (1, 128, 4, 64), (1, 256, 1, 64), (2, 96, 2, 32)]
#: B, S, Hq, Hkv, hd, causal, window, softcap of RecurrentGemma-9B's local attention.
RG_ATTN = (1, 4096, 16, 1, 256, True, 2048, None)
#: The attention of each new training cell (phase 1e): tag, (B, S, Hq, Hkv,
#: hd, causal, window, softcap).  The tag's first word is the cell's arch.
NEW_ATTN = [
    ("starcoder2-3b", (1, 4096, 24, 2, 128, True, None, None)),
    ("starcoder2-7b", (1, 4096, 36, 4, 128, True, None, None)),
    ("gemma2-2b local", (1, 8192, 8, 4, 256, True, 4096, 50.0)),
    ("gemma2-2b global", (1, 8192, 8, 4, 256, True, None, 50.0)),
    ("mixtral-8x7b", (1, 8192, 32, 8, 128, True, 4096, None)),
    ("dbrx-132b", (1, 4096, 48, 8, 128, True, None, None)),
    ("musicgen-large", (1, 4096, 32, 32, 64, True, None, None)),
    ("qwen2-vl-2b", (1, 4096, 12, 2, 128, True, None, None)),
]
#: Phase 10a: the dry run's cells, (arch, shape, extra CLI flags), each run in a
#: subprocess on a fake world of 256 (16x16) or 512 (2x16x16) ranks.
DRYRUN_CELLS = (
    ("tinyllama-1.1b", "train_4k", ()),
    ("tinyllama-1.1b", "train_4k", ("--remat", "dots")),
    ("dbrx-132b", "decode_32k", ()),
    ("recurrentgemma-9b", "long_500k", ("--multi-pod",)),
)
#: Phase 10a's pinned cell: TinyLlama x train_4k x 16x16 at reduced widths and 2 layers (the
#: CLI cell of tests/test_torch_dryrun.py), run first: its collectives by kind (counted by the
#: placement rule, ``launch/segments.py``) for the whole step and each segment, pinned in that
#: test too, must come out the same on this host's torch
DRYRUN_REDUCED_KEY = "tinyllama-1.1b__reduced"
DRYRUN_REDUCED_COUNTS = {
    "whole_program": {"all-gather": 86, "reduce-scatter": 32, "all-reduce": 14},
    "stage": {"all-gather": 28, "reduce-scatter": 14, "all-reduce": 4},
    "head": {"all-gather": 6, "reduce-scatter": 4, "all-reduce": 2},
}
DRYRUN_REDUCED = """
import sys
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun
red = get_reduced("tinyllama-1.1b")
sys.exit(dryrun.main(sys.argv[1:], overrides={"n_layers": 2, "d_model": red.d_model,
                                               "d_ff": red.d_ff, "vocab": red.vocab,
                                               "attention": red.attention}))
"""
#: The JAX dry-run record's keys (``repro/launch/dryrun.py``); a train cell
#: adds ``plan``, a decode cell ``serve_plan``.
DRYRUN_KEYS = {"arch", "shape", "mesh", "n_devices", "fsdp_data", "n_microbatches", "compile_s",
               "memory", "whole_program", "segments", "totals"}
DRYRUN_OUT = ROOT / "build" / "phase10"
#: Phase 10b: one rank's TinyLlama train_4k stage (batch 1 of the 256-way
#: batch, 4096 tokens) and its attention, B, S, Hq, Hkv, hd, causal, window,
#: softcap.
SHAPE_TRAIN_4K_SEQ = 4096
DRYRUN_ATTN = (1, 4096, 32, 4, 64, True, None, None)
#: Real max_memory_allocated against MemTracker's peak on fake tensors: ATen's
#: CUDA kernels make copies of their own (a batched product's operands made
#: contiguous) that no dispatch mode sees; +15.1% in the first reading.
DRYRUN_MEM_TOL = 0.20
#: The remat policy of the selective-checkpointing runs (phase 3's
#: ``post_f32_dots``, the cells of ``DOTS_CELLS``, phase 10's dots cell and
#: stage): their 2D products saved, the rest recomputed.
DOTS = {"remat": "dots"}
DOTS_CELLS = ("phase 3b", "phase 3c", "phase 3d")
#: Phases 3d-3j: tag, arch, depth override, launcher flags past the common
#: ones.  Every width is the published one; the depth cuts keep the static
#: bytes under the card's 80 GB (PERF.md section 4 reckons them).
NEW_CELLS = [
    ("phase 3d", "starcoder2-3b", {}, ["--batch", "1", "--seq", "4096"]),
    ("phase 3e", "starcoder2-7b", {"n_layers": 12}, ["--batch", "1", "--seq", "4096"]),
    ("phase 3f", "gemma2-2b", {}, ["--batch", "1", "--seq", "8192"]),
    ("phase 3g", "mixtral-8x7b", {"n_layers": 2}, ["--batch", "1", "--seq", "8192"]),
    ("phase 3h", "dbrx-132b", {"n_layers": 1},
     ["--batch", "1", "--seq", "4096", "--optimizer", "sgd"]),
    # the embeds-input archs: batches of (1, 4096, d) f32 embeds, the table's zero gradient
    ("phase 3i", "musicgen-large", {}, ["--batch", "1", "--seq", "4096"]),
    ("phase 3j", "qwen2-vl-2b", {}, ["--batch", "1", "--seq", "4096"]),
]
#: The JAX package's flash-attention test shapes (tests/test_kernels.py):
#: B, S, Hq, Hkv, hd, causal, window, softcap.
JAX_FWD_SHAPES = [
    (2, 256, 4, 2, 64, True, None, None),
    (1, 512, 8, 8, 128, True, None, None),
    (2, 256, 4, 1, 64, True, 128, None),
    (1, 256, 2, 2, 64, True, None, 50.0),
    (1, 256, 4, 2, 64, False, None, None),
    (1, 384, 6, 2, 128, True, 256, 30.0),
    (1, 128, 4, 4, 256, True, None, None),
]
JAX_BWD_SHAPES = [
    (1, 256, 4, 2, 64, True, None, None),
    (1, 256, 4, 4, 64, False, None, None),
    (1, 256, 2, 1, 64, True, 128, None),
    (1, 256, 2, 2, 64, True, None, 50.0),
    (1, 384, 6, 2, 128, True, 256, 30.0),
]


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def train(tag: str, args: list[str], **kwargs):
    """``launch.train.run`` of ``args`` in a fresh ``--ckpt-dir`` of its own
    (a restart restores the newest checkpoint there, so none may be stale);
    fails if a step failed and was retried, so that no restart can hide a
    kernel fault."""
    from repro_torch.launch.train import run

    ckpt = CKPT_ROOT / tag
    shutil.rmtree(ckpt, ignore_errors=True)
    res = run(args + ["--ckpt-dir", str(ckpt)], quiet=True, **kwargs)
    if res.restarts:
        fail(f"{tag}: {res.restarts} restart(s): a step failed and was retried")
    return res


def median_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median over ``reps`` of one call of ``fn``, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 10, tries: int = 4) -> float:
    """Device time of one call of ``fn``: the kernels (and copies) that
    torch.profiler records over ``calls`` calls, over ``calls``, after
    ``calls`` warm-up calls under the same tracer whose records it drops (a
    fresh tracer can lose its first records).  The host's time to enqueue
    them is not in it.  Every call launches at least one kernel, so a trace
    with fewer device events than calls lost some: it is taken again, up to
    ``tries`` times, and then the time is NaN (printed "nan": not
    measured).  Fails if no trace recorded a device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    seen = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        if len(events) >= calls:
            return sum(e.time_range.end - e.time_range.start for e in events) / calls / 1e3
        seen = max(seen, len(events))
    if not seen:
        fail(f"the profiler recorded no device events in {tries} traces")
    say(f"device time not measured: at most {seen} device events in {tries} traces of "
        f"{calls} calls")
    return math.nan


def host_ms(fn, calls: int = 20) -> float:
    """Host time of one call of ``fn`` while the card is busy (three 8192^3
    f32 products queued first), so that nothing waits for the device."""
    import torch

    big = torch.randn(8192, 8192, device="cuda")
    torch.cuda.synchronize()
    for _ in range(3):
        big @ big
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def max_abs_err(got, want) -> float:
    """0.0 when bit-identical, else the largest |difference| (inf/nan
    mismatches count as inf)."""
    import torch

    if torch.equal(got.view(-1).view(torch.uint8), want.view(-1).view(torch.uint8)):
        return 0.0
    d = (got.float() - want.float()).abs().nan_to_num(nan=math.inf)
    return float(d.max())


# ---------------------------------------------------------------------------
# Phase 1: the comm_pack kernels
# ---------------------------------------------------------------------------


def main_path_groups():
    """Per-group parameter shapes/dtypes of the full-width main path."""
    from repro_torch.configs import get_config
    from repro_torch.core.sync import SyncConfig
    from repro_torch.core.trainer import MGWFBPEngine
    from repro_torch.fabric import get_fabric
    from repro_torch.models import Transformer, param_shapes

    cfg = get_config("tinyllama-1.1b")
    eng = MGWFBPEngine.build(
        cfg, param_shapes(cfg),
        ar_model=get_fabric("gpu_nccl").cost("all_reduce", {"data": 32}),
        tokens_per_device=4 * 512, policy="mg_wfbp", sync_config=SyncConfig(fuse="arena"),
    )
    meta = dict(Transformer(cfg, device="meta", seed=None).named_parameters())
    return [[(meta[n].shape, meta[n].dtype) for n in names] for names in eng.sync.group_names]


def random_parts(specs, device, gen):
    import torch

    return [
        torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dt)
        for shape, dt in specs
    ]


def offsets_of(parts):
    out, off = [], 0
    for p in parts:
        out.append(off)
        off += p.numel()
    return out, off


def check_group(parts, wire, ef, scale, gen, errs) -> None:
    """One group through both kernels and both plain versions: arena,
    residuals and unpacked parts must be bit-identical."""
    import torch
    from repro_torch.kernels.comm_pack import (
        pack_arena, pack_arena_ref, unpack_arena, unpack_arena_ref,
    )

    offs, total = offsets_of(parts)
    res = None
    if ef:
        res = [torch.randn(p.shape, generator=gen, device=p.device) * 1e-2 for p in parts]
    want, want_res = pack_arena_ref(parts, offs, total, wire, res)
    got_res = None if res is None else [r.clone() for r in res]
    got = pack_arena(parts, offs, total, wire, got_res)
    torch.cuda.synchronize()
    e = max_abs_err(got, want)
    if ef:
        for g, w in zip(got_res, want_res):
            e = max(e, max_abs_err(g.reshape(-1), w))
    errs["pack"] = max(errs["pack"], e)
    if e:
        fail(f"pack kernel differs from its plain version (wire {wire}, ef {ef}): {e}")
    outs = [torch.empty_like(p) for p in parts]
    unpack_arena(got, offs, outs, scale)
    want_out = unpack_arena_ref(got, list(zip(offs, [p.numel() for p in parts])),
                                [p.dtype for p in parts], scale)
    torch.cuda.synchronize()
    e = max(max_abs_err(o.reshape(-1), w) for o, w in zip(outs, want_out))
    errs["unpack"] = max(errs["unpack"], e)
    if e:
        fail(f"unpack kernel differs from its plain version (wire {wire}): {e}")


def ragged_parts(device, gen):
    """Odd sizes, mixed dtypes, and sources that are not 16-byte aligned
    (views at an odd storage offset): every scalar head/tail path."""
    import torch

    # the 65,539-element part starts at an aligned offset and spans 9 tiles
    # (vector body, scalar tail); the rest sit at odd offsets (scalar path)
    sizes = [8, 65_539, 1, 7, 4097, 16, 8191, 3, 1001]
    parts = []
    for i, n in enumerate(sizes):
        dt = torch.float32 if i % 2 == 0 else torch.bfloat16
        base = torch.randn(n + 1, generator=gen, device=device).to(dt)
        parts.append(base[1:] if i % 4 == 3 else base[:n].clone())
    return parts


def phase_kernels(device):
    import torch
    from repro_torch.kernels.comm_pack import (
        pack_arena, pack_arena_ref, reset_counts, unpack_arena, unpack_arena_ref,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    group_specs = main_path_groups()
    errs = {"pack": 0.0, "unpack": 0.0}
    configs = [(torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True),
               (torch.float32, True)]
    n_checked = 0
    for specs in group_specs:
        parts = random_parts(specs, device, gen)
        for wire, ef in configs:
            check_group(parts, wire, ef, 1.0, gen, errs)
            n_checked += 1
        del parts
    ragged = ragged_parts(device, gen)
    for wire, ef in configs:
        check_group(ragged, wire, ef, 1.0 / 3.0, gen, errs)
        n_checked += 1
    say(f"phase 1: pack/unpack bit-identical to the plain versions on "
        f"{len(group_specs)} main-path groups and 1 ragged group x 4 configs "
        f"({n_checked} checks)")

    # --- timing: one step's worth of launches (every group) -------------
    # Each timed call is the wrapper as the trainer calls it: its host work
    # (rows and table lookup; the tables are uploaded once, during warm-up)
    # and one launch per group, between two CUDA events.
    groups = [random_parts(specs, device, gen) for specs in group_specs]
    layout = [offsets_of(parts) for parts in groups]
    sizes = [[p.numel() for p in parts] for parts in groups]
    timings = {}
    for wire, ef in configs[:3]:
        wb = torch.tensor([], dtype=wire).element_size()
        res = [[torch.zeros(p.shape, device=device) for p in parts] for parts in groups] if ef else None
        part_bytes = sum(p.numel() * p.element_size() for parts in groups for p in parts)
        n_elems = sum(total for _, total in layout)
        pack_bytes = part_bytes + n_elems * wb + (2 * 4 * n_elems if ef else 0)
        unpack_bytes = n_elems * wb + part_bytes

        def pack_k():
            return [pack_arena(parts, offs, total, wire, None if res is None else res[i])
                    for i, (parts, (offs, total)) in enumerate(zip(groups, layout))]

        def pack_p():
            return [pack_arena_ref(parts, offs, total, wire, None if res is None else res[i])
                    for i, (parts, (offs, total)) in enumerate(zip(groups, layout))]

        def pack_lib():
            out = [torch.empty(total, dtype=wire, device=device) for _, total in layout]
            for parts, arena in zip(groups, out):
                torch.cat([p.reshape(-1) for p in parts], out=arena)
            return out

        arenas = pack_k()
        outs = [[torch.empty_like(p) for p in parts] for parts in groups]

        def unpack_k(which=range(len(groups))):
            for i in which:
                unpack_arena(arenas[i], layout[i][0], outs[i], 1.0)

        def unpack_p():
            for arena, (offs, _), o in zip(arenas, layout, outs):
                unpack_arena_ref(arena, list(zip(offs, [t.numel() for t in o])),
                                 [t.dtype for t in o], 1.0)

        # at scale 1 unpack is a cast-copy of each slot: one _foreach_copy_
        # per group over views of the arena computes it for any dtypes
        lib_outs = [[torch.empty_like(p) for p in parts] for parts in groups]

        def unpack_lib():
            for arena, n, o in zip(arenas, sizes, lib_outs):
                torch._foreach_copy_(o, [v.view(t.shape) for v, t in zip(arena.split(n), o)])

        unpack_k()
        unpack_lib()
        torch.cuda.synchronize()
        lib_err = max(max_abs_err(a, b) for o, lo in zip(outs, lib_outs) for a, b in zip(o, lo))
        if lib_err:
            fail(f"_foreach_copy_ differs from the unpack kernel at scale 1 (wire {wire}): {lib_err}")

        # split_with_sizes_copy (FSDP2's unpack) takes only outputs of the
        # arena's dtype: time it, and the kernel, on the groups it accepts
        same = [i for i, o in enumerate(outs) if all(t.dtype == wire for t in o)]

        def split_lib():
            for i in same:
                torch.split_with_sizes_copy(arenas[i], sizes[i],
                                            out=[t.view(-1) for t in lib_outs[i]])

        tag = f"{str(wire).removeprefix('torch.')}{'_ef' if ef else ''}"
        timings[tag] = {
            "pack": {
                "ms": median_ms(pack_k), "plain_ms": median_ms(pack_p),
                "library_ms": None if ef else median_ms(pack_lib),
                "bytes": pack_bytes, "bound_ms": pack_bytes / HBM_BYTES_PER_S * 1e3,
            },
            "unpack": {
                "ms": median_ms(unpack_k), "plain_ms": median_ms(unpack_p),
                "library_ms": None if ef else median_ms(unpack_lib),
                "bytes": unpack_bytes, "bound_ms": unpack_bytes / HBM_BYTES_PER_S * 1e3,
            },
        }
        for k, t in timings[tag].items():
            lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
            say(f"phase 1: {k:6s} wire={tag:9s} {len(groups)} launches/step: "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {lib}, "
                f"{t['bytes'] / 1e9:.3f} GB, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_ms'] / t['ms'] * 100:.1f}% of bound)")
        if same and not ef:
            say(f"phase 1: unpack wire={tag:9s} on the {len(same)} of {len(groups)} groups "
                f"whose outputs are {tag} (split_with_sizes_copy refuses the rest): kernel "
                f"{median_ms(lambda: unpack_k(same)):.4f} ms, split_with_sizes_copy "
                f"{median_ms(split_lib):.4f} ms")
        elif not ef:
            say(f"phase 1: unpack wire={tag:9s}: split_with_sizes_copy accepts none of the "
                f"{len(groups)} groups (each holds an output of another dtype)")
        del arenas, outs, lib_outs, res
    del groups
    torch.cuda.empty_cache()
    reset_counts()
    return errs, timings


# ---------------------------------------------------------------------------
# Phase 1b: the flash-attention kernels
# ---------------------------------------------------------------------------


def fmt_rel(rel: dict) -> str:
    return ", ".join(f"{k} {v:.3e}" for k, v in rel.items())


def flash_inputs(B, Sq, Sk, Hq, Hkv, hd, dtype, device, seed):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, generator=gen, device=device).to(dtype)
    return mk(B, Sq, Hq, hd), mk(B, Sk, Hkv, hd), mk(B, Sk, Hkv, hd), mk(B, Sq, Hq, hd)


def check_flash_case(shape, dtype, device, seed, errs, sq=None, rel=None) -> dict:
    """One shape through the three kernels and their plain versions on the
    same CUDA tensors; dQ and dK/dV take the plain forward's lse and delta.
    Keeps each kernel's max |difference| in ``errs`` and, for bf16, each
    output's max |difference| / max |want| in ``rel``, with the largest
    per-row relative L2 error of o (and fails past the tolerance)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    B, S, Hq, Hkv, hd, causal, window, softcap = shape
    q, k, v, do = flash_inputs(B, sq or S, S, Hq, Hkv, hd, dtype, device, seed)
    opts = dict(causal=causal, window=window, softcap=softcap)
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    want_o, want_lse = fa.flash_attention_fwd_ref(q, k, v, **opts)
    delta = fa.attention_delta(want_o, do)
    dq = fa.flash_attention_dq(q, k, v, do, want_lse, delta, **opts)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, want_lse, delta, **opts)
    want_dq = fa.flash_attention_dq_ref(q, k, v, do, want_lse, delta, **opts)
    want_dk, want_dv = fa.flash_attention_dkv_ref(q, k, v, do, want_lse, delta, **opts)
    torch.cuda.synchronize()
    tag = f"{shape} {str(dtype).removeprefix('torch.')}" + (f" Sq {sq}" if sq else "")
    bf16 = dtype == torch.bfloat16
    out = {}

    def close(name, got, want, tol, rel_to_max=False):
        d = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        if rel_to_max:
            ok = float(d.max()) <= tol * top
        else:
            ok = bool((d <= tol + tol * want.float().abs()).all())
        if not ok or not torch.isfinite(got.float()).all():
            fail(f"flash {name} differs from its plain version at {tag}: max |diff| "
                 f"{float(d.max()):.3e} (tolerance {tol}{' x max|g|' if rel_to_max else ''})")
        if bf16 and rel is not None and name != "lse":
            rel[name] = max(rel.get(name, 0.0), float(d.max()) / max(top, 1e-30))
        return float(d.max())

    out["fwd"] = max(close("o", o, want_o, 2e-2 if bf16 else 2e-5),
                     close("lse", lse, want_lse, 1e-5))
    if bf16:  # o row by row: |o - want| <= 1e-2 |want| in L2 over the head dim
        row = (o.float() - want_o.float()).norm(dim=-1) / want_o.float().norm(dim=-1)
        row = torch.where(want_o.float().norm(dim=-1) == 0, (o != 0).any(dim=-1).float(), row)
        worst = float(row.max())
        if not worst <= 1e-2:
            fail(f"flash o differs from its plain version at {tag}: per-row relative L2 "
                 f"{worst:.3e} > 1e-2")
        if rel is not None:
            rel["o row L2"] = max(rel.get("o row L2", 0.0), worst)
    out["dq"] = close("dq", dq, want_dq, 1e-2 if bf16 else 2e-4, rel_to_max=bf16)
    out["dkv"] = max(close("dk", dk, want_dk, 1e-2 if bf16 else 2e-4, rel_to_max=bf16),
                     close("dv", dv, want_dv, 1e-2 if bf16 else 2e-4, rel_to_max=bf16))
    for name, e in out.items():
        errs[name] = max(errs[name], e)
    return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv, "inputs": (q, k, v, do),
            "want_lse": want_lse, "delta": delta}


def check_fwd_bwd(shape, device, seed) -> dict:
    """Forward -> backward through the kernels' own (o, lse): dq, dk, dv of
    ``flash_attention_train`` (bf16, on the card) against the plain backward
    fed the plain forward's (o, lse), within 1e-2 x max|g|.  Returns each
    gradient's max |difference| / max |want|."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    B, S, Hq, Hkv, hd, causal, window, softcap = shape
    q, k, v, do = flash_inputs(B, S, S, Hq, Hkv, hd, torch.bfloat16, device, seed)
    opts = dict(causal=causal, window=window, softcap=softcap)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    fa.flash_attention_train(qg, kg, vg, **opts).backward(do)
    want_o, want_lse = fa.flash_attention_fwd_ref(q, k, v, **opts)
    want = fa.flash_attention_bwd_ref(q, k, v, want_o, want_lse, do, **opts)
    torch.cuda.synchronize()
    out = {}
    for name, got, w in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad), want):
        d, top = float((got.float() - w.float()).abs().max()), float(w.float().abs().max())
        if not d <= 1e-2 * top or not torch.isfinite(got.float()).all():
            fail(f"flash fwd -> bwd through the kernels' own (o, lse) at {shape[:5]}: {name} "
                 f"max |diff| {d:.3e} > 1e-2 x max|g| {top:.3e}")
        out[name] = d / top
    return out


def flash_work(B, S, Hq, Hkv, hd, itemsize, window=None):
    """Bytes each kernel must move (each input read once, each output
    written once) and the operations of its products (2 per multiply-add)
    over the (query, key) pairs that the causal mask (and the window) leave."""
    w = S if window is None else min(window, S)
    pairs = B * Hq * (w * (w + 1) // 2 + (S - w) * w)
    qb, kvb, rows = B * S * Hq * hd * itemsize, B * S * Hkv * hd * itemsize, B * S * Hq * 4
    return {
        "fwd": (2 * qb + 2 * kvb + rows, 2 * 2 * hd * pairs),  # q, k, v -> o, lse
        "dq": (3 * qb + 2 * kvb + 2 * rows, 3 * 2 * hd * pairs),  # q, k, v, dO, lse, delta -> dq
        "dkv": (2 * qb + 4 * kvb + 2 * rows, 4 * 2 * hd * pairs),  # ... -> dk, dv
    }


def time_flash(shape, device, seed, tag, plain_reps=7):
    """Each flash kernel's time per launch at ``shape`` in bf16 (CUDA-event
    median), its plain version's (median of ``plain_reps``), and one
    PyTorch call's forward and backward as the library yardsticks, beside
    the bound from ``flash_work``.  The call is
    ``F.scaled_dot_product_attention`` (the window, if any, as a boolean
    mask); SDPA computes no softcap, so at a softcap shape it is
    ``torch.compile(flex_attention)`` with the tanh softcap as its
    ``score_mod`` and the causal (and window) mask as its ``block_mask``.
    The yardstick (``attention_yardstick``) is timed only (the port never
    calls it), after its o is held within phase 1b's bf16 tolerance of the
    kernel's."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    B, S, Hq, Hkv, hd, _, window, softcap = shape
    q, k, v, do = flash_inputs(B, S, S, Hq, Hkv, hd, torch.bfloat16, device, seed)
    opts = dict(window=window, softcap=softcap)
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    delta = fa.attention_delta(o, do)
    calls = {
        "fwd": (lambda: fa.flash_attention_fwd(q, k, v, return_lse=True, **opts),
                lambda: fa.flash_attention_fwd_ref(q, k, v, **opts)),
        "dq": (lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, **opts),
               lambda: fa.flash_attention_dq_ref(q, k, v, do, lse, delta, **opts)),
        "dkv": (lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta, **opts),
                lambda: fa.flash_attention_dkv_ref(q, k, v, do, lse, delta, **opts)),
    }
    # the library yardstick, on (B, H, S, hd) views: its forward, and its
    # backward as one figure for dQ + dK/dV
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    lib_name, library = attention_yardstick(qt, kt, vt, window, softcap, device)
    out = library()
    if not torch.allclose(out.transpose(1, 2).float(), o.float(), rtol=2e-2, atol=2e-2):
        fail(f"{tag}: the yardstick {lib_name} does not compute the kernel's function: max "
             f"|o diff| {float((out.transpose(1, 2).float() - o.float()).abs().max()):.3e}")

    def library_bwd():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    lib = {"fwd": median_ms(library), "bwd": median_ms(library_bwd)}
    timings = {}
    work = flash_work(B, S, Hq, Hkv, hd, 2, window=window)
    where = f"{shape[:5]}" + (f" window {window}" if window else "") + \
        (f" softcap {softcap}" if softcap else "")
    masked = " (window as a mask)" if window else ""
    for name, (kern, plain) in calls.items():
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        timings[name] = t = {
            "ms": median_ms(kern), "plain_ms": median_ms(plain, reps=plain_reps),
            "library_ms": lib["fwd"] if name == "fwd" else lib["bwd"],
            "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        yardstick = f"{lib_name} fwd" if name == "fwd" else f"{lib_name} bwd (dQ+dK+dV)"
        say(f"{tag}: flash {name:3s} {where} bf16, one launch: {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, {yardstick} {t['library_ms']:.4f} ms{masked}, "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP, bound "
            f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} "
            f"({t['bound_ms'] / t['ms'] * 100:.2f}% of bound)")
    bwd_ms = timings["dq"]["ms"] + timings["dkv"]["ms"]
    bwd_bound = timings["dq"]["bound_ms"] + timings["dkv"]["bound_ms"]
    say(f"{tag}: flash dQ + dK/dV {where} bf16: {bwd_ms:.4f} ms against {lib_name} bwd "
        f"{lib['bwd']:.4f} ms: {bwd_ms / lib['bwd']:.2f}x {lib_name}; bound "
        f"{bwd_bound * 1e3:.2f} us ({bwd_bound / bwd_ms * 100:.2f}% of bound)")
    # one launch timed alone also holds the host's time to enqueue it (the
    # wrapper's Python, which matters at small shapes): the device time and
    # the host time of the same calls, for both sides
    dev_ms, dev_lib = device_ms(calls["fwd"][0]), device_ms(library)
    say(f"{tag}: flash fwd {where} bf16, device time (torch.profiler, 10 calls): {dev_ms:.4f} ms "
        f"a call, {lib_name} fwd {dev_lib:.4f} ms: {dev_ms / dev_lib:.2f}x {lib_name}; host "
        f"time of a call while the card is busy: ours {host_ms(calls['fwd'][0]):.4f} ms, "
        f"{lib_name} fwd {host_ms(library):.4f} ms")
    ours = lambda: (calls["dq"][0](), calls["dkv"][0]())
    dev_ms, dev_lib = device_ms(ours), device_ms(library_bwd)
    say(f"{tag}: flash dQ + dK/dV {where} bf16, device time (torch.profiler, 10 calls): "
        f"{dev_ms:.4f} ms a call, {lib_name} bwd {dev_lib:.4f} ms: {dev_ms / dev_lib:.2f}x "
        f"{lib_name}; host time of a call while the card is busy: dQ "
        f"{host_ms(calls['dq'][0]):.4f} ms, dK/dV {host_ms(calls['dkv'][0]):.4f} ms, "
        f"{lib_name} bwd {host_ms(library_bwd):.4f} ms")
    del q, k, v, do, o, lse, delta, qt, kt, vt, out
    torch.cuda.empty_cache()
    return timings


def attention_yardstick(qt, kt, vt, window, softcap, device):
    """The one PyTorch call that computes the flash forward's function on
    (B, H, S, hd) views, as ``(name, call)``: SDPA, causal (the window as a
    mask), or at a softcap, which SDPA does not compute,
    ``torch.compile(flex_attention)`` with the tanh softcap as its
    ``score_mod``."""
    import torch
    import torch.nn.functional as F

    S = qt.shape[2]
    if softcap:
        import os

        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        # the compiled yardstick's caches stay inside the checkout's build/
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "torchinductor"))
        os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

        def mask_mod(b, h, i, j):
            return (i >= j) if window is None else (i >= j) & (i - j < window)

        def score_mod(score, b, h, i, j):
            return softcap * torch.tanh(score / softcap)

        block_mask = create_block_mask(mask_mod, None, None, S, S, device=device)
        flex = torch.compile(flex_attention)
        return "flex_attention", lambda: flex(qt, kt, vt, score_mod=score_mod,
                                              block_mask=block_mask, enable_gqa=True)
    if window is None:
        opts = dict(is_causal=True)
    else:
        pos = torch.arange(S, device=device)
        opts = dict(attn_mask=(pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window))
    return "SDPA", lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **opts)


def phase_flash(device):
    import torch
    from repro_torch.kernels import flash_attention as fa

    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    rel = {}
    main = (*MAIN_ATTN, True, None, None)
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        res = check_flash_case(main, dtype, device, 0, errs, rel=rel)
        n += 1
        if dtype == torch.bfloat16:
            main_errs, main_rel = dict(errs), dict(rel)
            # the same inputs again: every output must repeat bit for bit
            q, k, v, do = res["inputs"]
            o2, lse2 = fa.flash_attention_fwd(q, k, v, return_lse=True)
            dq2 = fa.flash_attention_dq(q, k, v, do, res["want_lse"], res["delta"])
            dk2, dv2 = fa.flash_attention_dkv(q, k, v, do, res["want_lse"], res["delta"])
            for name, a, b in (("o", o2, res["o"]), ("lse", lse2, res["lse"]), ("dq", dq2, res["dq"]),
                               ("dk", dk2, res["dk"]), ("dv", dv2, res["dv"])):
                if not torch.equal(a, b):
                    fail(f"flash {name}: a second run on the same inputs gave other bits")
        del res
    for i, shape in enumerate(JAX_FWD_SHAPES + JAX_BWD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            check_flash_case(shape, dtype, device, 10 + i, errs, rel=rel)
            n += 1
    # rows 191.. of q see no key (k shorter than q, window 64)
    for dtype in (torch.float32, torch.bfloat16):
        res = check_flash_case((1, 128, 4, 2, 64, True, 64, None), dtype, device, 99, errs, sq=256,
                               rel=rel)
        n += 1
        q, k, v, _ = res["inputs"]
        want = fa.attention_ref(q, k, v, window=64)
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        if not torch.allclose(res["o"].float(), want.float(), rtol=tol, atol=tol):
            fail("flash forward differs from attention_ref where rows see no key")
        if not torch.equal(res["o"][:, 191:], torch.zeros_like(res["o"][:, 191:])):
            fail("flash forward: rows that see no key are not 0")
        del res
    say(f"phase 1b: flash fwd/dQ/dK-dV within tolerance of the plain versions on {n} cases "
        f"(main path bf16 max |diff|: fwd {main_errs['fwd']:.3e}, dq {main_errs['dq']:.3e}, "
        f"dkv {main_errs['dkv']:.3e}; over all cases: fwd {errs['fwd']:.3e}, dq {errs['dq']:.3e}, "
        f"dkv {errs['dkv']:.3e}); rows that see no key are 0; repeated runs bitwise equal")
    say(f"phase 1b: bf16 max |diff| / max|want|, main path: {fmt_rel(main_rel)}; over all bf16 "
        f"cases: {fmt_rel(rel)}")
    fb = check_fwd_bwd(main, device, 2)
    say(f"phase 1b: flash fwd -> bwd through the kernels' own (o, lse) at {MAIN_ATTN} bf16: "
        f"max |diff| / max|g| {fmt_rel(fb)} (<= 1e-2)")

    timings = time_flash((*MAIN_ATTN, True, None, None), device, 1, "phase 1b")
    fa.reset_counts()
    return main_errs, timings


# ---------------------------------------------------------------------------
# Phase 1c: the RG-LRU kernels, and flash at RecurrentGemma's attention
# ---------------------------------------------------------------------------


def rglru_inputs(B, T, W, device, seed):
    """As the JAX package's tests draw them: a = sigmoid(2 n + 2), g = 0.5 n;
    h0, the cotangent dh and dhT = n."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    return (torch.sigmoid(2.0 * n(B, T, W) + 2.0), 0.5 * n(B, T, W), n(B, W), n(B, T, W),
            n(B, W))


def phase_rglru(device):
    import torch
    from repro_torch.kernels import rglru as rg

    # the largest |diff| of the forward, of the gradients, and of the forward at the
    # prefill shape alone
    errs = {"fwd": 0.0, "bwd": 0.0, "prefill": 0.0}
    thr = rg.step_max_t()  # the longest T of the forward's step kernel

    def close(name, got, want, tag, grad=False):
        d = (got - want).abs()
        if grad:
            ok = float(d.max()) <= 1e-5 * max(1.0, float(want.abs().max()))
        else:
            ok = bool((d <= 1e-5 + 1e-5 * want.abs()).all())
        if not ok or not torch.isfinite(got).all():
            fail(f"rglru {name} differs from its plain version at {tag}: max |diff| "
                 f"{float(d.max()):.3e}")
        errs["bwd" if grad else "fwd"] = max(errs["bwd" if grad else "fwd"], float(d.max()))
        return float(d.max())

    # the JAX tests' shapes, the training, prefill and decode shapes, and T on either side
    # of the step kernel's threshold and of the tiles' 256 steps at ragged W, B 1 and 4
    shapes = JAX_RGLRU_SHAPES + [MAIN_RGLRU, PREFILL_RGLRU, DECODE_RGLRU, (4, 2, 4096)]
    shapes += [(B, T, W) for T in (thr - 1, thr, thr + 1, 255, 256, 257, 300)
               for B, W in ((1, 40), (4, 4097))]
    n = 0
    for i, shape in enumerate(shapes):
        for with_h0 in (False, True):
            a, g, h0, dh, dhT = rglru_inputs(*shape, device, seed=40 + i)
            h0 = h0 if with_h0 else None
            tag = f"{shape}{' h0' if with_h0 else ''}"
            h, hT = rg.rglru_fwd(a, g, h0)
            da, dg, dh0 = rg.rglru_bwd(a, h, h0, dh, dhT)
            want_h, want_hT = rg.rglru_ref(a, g, h0)
            want_da, want_dg, want_dh0 = rg.rglru_bwd_ref(a, h, h0, dh, dhT)
            torch.cuda.synchronize()
            err = max(close("h", h, want_h, tag), close("hT", hT, want_hT, tag))
            if shape == PREFILL_RGLRU:
                errs["prefill"] = max(errs["prefill"], err)
            if not torch.equal(hT, h[:, -1]):
                fail(f"rglru hT is not h[:, -1] at {tag}")
            close("da", da, want_da, tag, grad=True)
            close("dg", dg, want_dg, tag, grad=True)
            if with_h0:
                close("dh0", dh0, want_dh0, tag, grad=True)
            h2, hT2 = rg.rglru_fwd(a, g, h0)
            da2, dg2, _ = rg.rglru_bwd(a, h, h0, dh, dhT)
            if not all(torch.equal(x, y) for x, y in ((h2, h), (hT2, hT), (da2, da), (dg2, dg))):
                fail(f"rglru: a second run on the same inputs gave other bits at {tag}")
            n += 1
    B, T, W = MAIN_RGLRU
    a, g, _, dh, _ = rglru_inputs(B, T, W, device, seed=1)
    h, hT = rg.rglru_fwd(a, g)
    h_a, s_a = rg.rglru_fwd(a[:, : T // 2], g[:, : T // 2])
    h_b, s_b = rg.rglru_fwd(a[:, T // 2 :], g[:, T // 2 :], s_a)
    split = max(float((torch.cat([h_a, h_b], 1) - h).abs().max()), float((s_b - hT).abs().max()))
    if split > 1e-5:
        fail(f"rglru: a run split at T/2 and threaded through hT -> h0 differs by {split:.3e}")
    # across the threshold: the first thr steps through the step kernel, the rest tiled
    a3, g3, h03 = rglru_inputs(4, 300, 4096, device, seed=2)[:3]
    h, hT = rg.rglru_fwd(a3, g3, h03)
    h_a, s_a = rg.rglru_fwd(a3[:, :thr], g3[:, :thr], h03)
    h_b, s_b = rg.rglru_fwd(a3[:, thr:], g3[:, thr:], s_a)
    across = max(float((torch.cat([h_a, h_b], 1) - h).abs().max()),
                 float((s_b - hT).abs().max()))
    if across > 1e-5:
        fail(f"rglru: a run split at T {thr} (step kernel, then tiled) and threaded through "
             f"hT -> h0 differs from one run by {across:.3e}")
    # a row alone has the bits it has in a batch of 4 (the serving gate batched == alone)
    for T3 in (1, 300):
        a3, g3, h03, dh3, dhT3 = rglru_inputs(4, T3, 4096, device, seed=3)
        h, hT = rg.rglru_fwd(a3, g3, h03)
        da, dg, dh0 = rg.rglru_bwd(a3, h, h03, dh3, dhT3)
        for b in range(4):
            r = slice(b, b + 1)
            alone = rg.rglru_fwd(a3[r], g3[r], h03[r]) + rg.rglru_bwd(a3[r], h[r], h03[r],
                                                                     dh3[r], dhT3[r])
            if not all(torch.equal(x, y[r]) for x, y in zip(alone, (h, hT, da, dg, dh0))):
                fail(f"rglru: row {b} alone differs from row {b} of a B 4 call at T {T3}")
    # up to the threshold the step kernel walks the fmafs of the tiled kernel's first chunk
    # from h0, so its h is bitwise the first steps of a tiled call one step longer: at T 1,
    # fmaf(a, h0, g), the decode step's bits before the step kernel
    a3, g3, h03 = rglru_inputs(4, thr + 1, 4096, device, seed=4)[:3]
    tiled = rg.rglru_fwd(a3, g3, h03)[0]
    for T3 in (1, thr):
        step = rg.rglru_fwd(a3[:, :T3].contiguous(), g3[:, :T3].contiguous(), h03)[0]
        if not torch.equal(step, tiled[:, :T3]):
            fail(f"rglru: the step kernel at (4, {T3}, 4096) differs from the first {T3} steps "
                 f"of the tiled kernel's")
    say(f"phase 1c: rglru fwd/bwd within tolerance of the plain versions on {n} cases (the "
        f"forward's step kernel up to T {thr}; max |diff| h {errs['fwd']:.3e}, at "
        f"{PREFILL_RGLRU} {errs['prefill']:.3e}, gradients {errs['bwd']:.3e}); hT == h[:, -1]; "
        f"split at T/2 through hT -> h0 {split:.3e}, split at T {thr} across the threshold "
        f"{across:.3e}; repeated runs bitwise equal; rows alone == rows of a B 4 call at T 1 "
        f"and 300, bitwise; the step kernel's h at T 1 and {thr} == the tiled kernel's first "
        f"steps, bitwise")
    del a3, g3, h03, dh3, dhT3, h, hT, da, dg, dh0, h_a, h_b, tiled, step

    # --- timing in each mode, as the paths call them: training (no h0, no dhT), the
    # 2304-token prefill (6b's longest), the decode step (h0 from the engine's state)
    timings = {}
    for mode, name, (B, T, W), with_h0 in (("train", "fwd", MAIN_RGLRU, False),
                                           ("train", "bwd", MAIN_RGLRU, False),
                                           ("prefill", "fwd", PREFILL_RGLRU, False),
                                           ("decode", "fwd", DECODE_RGLRU, True)):
        a, g, h0, dh, _ = rglru_inputs(B, T, W, device, seed=1)
        h0 = h0 if with_h0 else None
        elems = B * T * W
        if name == "fwd":
            kern, plain = (lambda: rg.rglru_fwd(a, g, h0)), (lambda: rg.rglru_ref(a, g, h0))
            # a, g (, h0) -> h, hT; one multiply-add a step
            nbytes = 3 * 4 * elems + 4 * B * W * (2 if with_h0 else 1)
            flops = 2 * elems
        else:
            h = rg.rglru_fwd(a, g)[0]
            kern, plain = (lambda: rg.rglru_bwd(a, h, None, dh)), (
                lambda: rg.rglru_bwd_ref(a, h, None, dh))
            nbytes, flops = 5 * 4 * elems, 3 * elems  # a, h, dh -> da, dg
        # at T 1 the recurrence is one multiply-add, which torch.addcmul computes
        library = (lambda: torch.addcmul(g[:, 0], a[:, 0], h0)) if mode == "decode" else None
        t = kernel_timing(kern, plain, library, nbytes, flops, PEAK_FLOPS["float32"])
        t.update(bytes=nbytes, dev_ms=device_ms(kern, calls=50),
                 library_dev_ms=None if library is None else device_ms(library, calls=50))
        timings[name if mode == "train" else mode] = t
        lib = "library none (no PyTorch call computes a linear recurrence)"
        if library is not None:
            lib = (f"torch.addcmul {t['library_ms']:.4f} ms, device {t['library_dev_ms'] * 1e3:.2f} "
                   f"us (kernel / addcmul device {t['dev_ms'] / t['library_dev_ms']:.2f}x)")
        say(f"phase 1c: rglru {name} {mode} {(B, T, W)} f32{' h0' if with_h0 else ''}, one "
            f"launch: {t['ms']:.4f} ms, device {t['dev_ms'] * 1e3:.2f} us, plain "
            f"{t['plain_ms']:.4f} ms, {lib}, {nbytes / 1e6:.2f} MB, bound "
            f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} ({t['bound_ms'] / t['ms'] * 100:.1f}% "
            f"of bound by events, {t['bound_ms'] / t['dev_ms'] * 100:.1f}% by device time)")
        del a, g, h0, dh
    # either side of the threshold: the step kernel at T thr, the tiled one at thr + 1
    cmp = []
    for B in (1, 4):
        for T in (thr, thr + 1):
            a, g, h0 = rglru_inputs(B, T, 4096, device, seed=5)[:3]
            cmp.append(f"({B}, {T}) {device_ms(lambda: rg.rglru_fwd(a, g, h0), calls=50) * 1e3:.2f}")
    say(f"phase 1c: rglru_fwd at (B, T, 4096) with h0, the step kernel to T {thr} and the tiled "
        f"one past it, device us a launch: {', '.join(cmp)}")
    del a, g, h0
    torch.cuda.empty_cache()
    rg.reset_counts()
    return errs, timings


def phase_rg_flash(device):
    """The flash kernels at RecurrentGemma-9B's attention: MQA (16 query
    heads over 1 KV head), hd 256, causal, window 2048, bf16."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    rel = {}
    window = RG_ATTN[6]
    res = check_flash_case(RG_ATTN, torch.bfloat16, device, 7, errs, rel=rel)
    q, k, v, do = res["inputs"]
    o2 = fa.flash_attention_fwd(q, k, v, window=window)
    dq2 = fa.flash_attention_dq(q, k, v, do, res["want_lse"], res["delta"], window=window)
    dk2, dv2 = fa.flash_attention_dkv(q, k, v, do, res["want_lse"], res["delta"], window=window)
    for name, a, b in (("o", o2, res["o"]), ("dq", dq2, res["dq"]), ("dk", dk2, res["dk"]),
                       ("dv", dv2, res["dv"])):
        if not torch.equal(a, b):
            fail(f"flash {name} at RecurrentGemma's attention: a second run gave other bits")
    say(f"phase 1c: flash fwd/dQ/dK-dV at {RG_ATTN[:5]} window {window} bf16 within tolerance of "
        f"the plain versions (max |diff| fwd {errs['fwd']:.3e}, dq {errs['dq']:.3e}, "
        f"dkv {errs['dkv']:.3e}; max |diff| / max|want| {fmt_rel(rel)}); repeated runs bitwise "
        f"equal")
    del res, q, k, v, do, o2, dq2, dk2, dv2
    torch.cuda.empty_cache()
    fb = check_fwd_bwd(RG_ATTN, device, 9)
    say(f"phase 1c: flash fwd -> bwd through the kernels' own (o, lse) at {RG_ATTN[:5]} window "
        f"{window} bf16: max |diff| / max|g| {fmt_rel(fb)} (<= 1e-2)")
    torch.cuda.empty_cache()
    timings = time_flash(RG_ATTN, device, 8, "phase 1c")
    fa.reset_counts()
    return errs, timings


# ---------------------------------------------------------------------------
# Phase 1d: the WKV6 kernels
# ---------------------------------------------------------------------------


def wkv_inputs(B, T, H, K, device, seed, dtype, w_range=None):
    """As the JAX package's tests draw them: r, k, v = n (in ``dtype``),
    w = exp(-exp(U(-6, -0.8))) in ~(0.63, 0.999) (or uniform in ``w_range``),
    u = 0.5 n; s0 and the cotangents dout and ds_final = n."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    r, k, v = (n(B, T, H, K).to(dtype) for _ in range(3))
    x = torch.rand(B, T, H, K, generator=gen, device=device)
    w = (w_range[0] + (w_range[1] - w_range[0]) * x if w_range
         else torch.exp(-torch.exp(-6.0 + 5.2 * x)))
    return r, k, v, w, 0.5 * n(H, K), n(B, H, K, K), n(B, T, H, K), n(B, H, K, K)


def phase_wkv(device):
    import torch
    from repro_torch.kernels import rwkv6_wkv as wk

    errs = {"fwd": 0.0, "bwd": 0.0}
    gate = {"share": 0.0, "at": ""}  # the largest forward |diff| / (2e-4 + 2e-4 |ref|)
    names = ("dr", "dk", "dv", "dw", "du", "ds0")

    def check_out(out, s_final, want_out, want_s, tag) -> float:
        """Holds out and s_final (each unless None) at the gate; returns the
        larger reading as a share of the gate."""
        worst = 0.0
        for name, got, ref in (("out", out, want_out), ("s_final", s_final, want_s)):
            if got is None:
                continue
            d = (got - ref).abs()
            if not bool((d <= 2e-4 + 2e-4 * ref.abs()).all()) or not torch.isfinite(got).all():
                fail(f"wkv {name} differs from its plain version at {tag}: max |diff| "
                     f"{float(d.max()):.3e}")
            errs["fwd"] = max(errs["fwd"], float(d.max()))
            share = float((d / (2e-4 + 2e-4 * ref.abs())).max())
            worst = max(worst, share)
            if share > gate["share"]:
                gate.update(share=share, at=f"{name} at {tag}")
        return worst

    def check_fwd(r, k, v, w, u, s0, tag, exact=False, state_only=False):
        """The forward against wkv_ref (in f64 on f64 copies of the inputs if
        ``exact``), out unless ``state_only`` and s_final; a second run must
        give the same bits.  Returns the reading as a share of the gate."""
        out, s_final = wk.wkv_fwd(r, k, v, w, u, s0)
        args = (r, k, v, w, u, s0)
        want_out, want_s = wk.wkv_ref(*(t.double() if exact and t is not None else t
                                        for t in args))
        torch.cuda.synchronize()
        share = check_out(None if state_only else out, s_final, want_out, want_s, tag)
        out2, s2 = wk.wkv_fwd(r, k, v, w, u, s0)
        if not (torch.equal(out2, out) and torch.equal(s2, s_final)):
            fail(f"wkv: a second forward on the same inputs gave other bits at {tag}")
        return share

    bgate = {"share": 0.0, "at": ""}  # the largest gradient |diff| / (2e-4 max(1, max|g|))

    def check_bwd(inputs, tag, exact=False):
        """wkv_bwd against wkv_bwd_ref (in f64 on f64 copies if ``exact``): every
        gradient within the gate and finite; with the forward's chunk states handed
        over, and a second run, the same bits."""
        grads = wk.wkv_bwd(*inputs)
        if (grads[-1] is None) != (inputs[5] is None):
            fail(f"wkv ds0 is {grads[-1]!r} with s0 {'absent' if inputs[5] is None else 'given'} "
                 f"at {tag}")
        want = wk.wkv_bwd_ref(*(None if t is None else t.double() for t in inputs)
                              if exact else inputs)
        torch.cuda.synchronize()
        for name, got, ref in zip(names, grads, want):
            if ref is None:
                continue
            d = float((got.double() - ref.double()).abs().max())
            share = d / (2e-4 * max(1.0, float(ref.abs().max())))
            if not share <= 1.0 or not torch.isfinite(got).all():
                fail(f"wkv {name} differs from its plain version at {tag}: max |diff| {d:.3e}, "
                     f"{share:.3f} of the gate")
            errs["bwd"] = max(errs["bwd"], d)
            if share > bgate["share"]:
                bgate.update(share=share, at=f"{name} at {tag}")
        states = wk.ops._wkv_fwd(*inputs[:6])[2]
        for again in (wk.wkv_bwd(*inputs, chunk_states=states), wk.wkv_bwd(*inputs)):
            if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(grads, again)):
                fail(f"wkv bwd: handed chunk states or a second run gave other bits at {tag}")

    def check(inputs, tag):
        check_fwd(*inputs[:6], tag)
        check_bwd(inputs, tag)

    n = 0
    for i, shape in enumerate(JAX_WKV_SHAPES + [MAIN_WKV]):
        for dtype in (torch.float32, torch.bfloat16):
            for with_state in (False, True):
                r, k, v, w, u, s0, dout, ds = wkv_inputs(*shape, device, 60 + i, dtype)
                if not with_state:
                    s0, ds = None, None
                check((r, k, v, w, u, s0, dout, ds),
                      f"{shape} {str(dtype)[6:]}{' s0/ds_final' if with_state else ''}")
                n += 1
    check(wkv_inputs(1, 256, 4, 64, device, 70, torch.float32, w_range=(0.05, 0.3)),
          "(1, 256, 4, 64) strong decay w in (0.05, 0.3)")
    B, T, H, K = MAIN_WKV
    r, k, v, w, u, _, dout, _ = wkv_inputs(B, T, H, K, device, 1, torch.bfloat16)
    out, s_final = wk.wkv_fwd(r, k, v, w, u)
    h = T // 2
    out_a, s_a = wk.wkv_fwd(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u)
    out_b, s_b = wk.wkv_fwd(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s_a)
    split = max(float((torch.cat([out_a, out_b], 1) - out).abs().max()),
                float((s_b - s_final).abs().max()))
    if split > 2e-4 * max(1.0, float(out.abs().max())):
        fail(f"wkv: a run split at T/2 and threaded through s_final -> s0 differs by {split:.3e}")
    say(f"phase 1d: wkv fwd/bwd within tolerance of the plain versions on {n + 1} cases "
        f"(max |diff| out/s_final {errs['fwd']:.3e}, gradients {errs['bwd']:.3e}; strong decay "
        f"included); split at T/2 through s_final -> s0 {split:.3e}; repeated runs bitwise equal")

    # --- the chunked forward alone: its chunk and sub-chunk boundaries, the decays
    # where exponents could cancel or underflow, a split off the chunk grid
    n_fwd = 0
    for Tb in (1, 8, 9, 15, 16, 63, 64, 65, 4096 + 17):
        for shape, dtype, with_s0 in (((1, Tb, H, K), torch.bfloat16, False),
                                      ((1, Tb, 4, 32), torch.float32, True)):
            rb, kb, vb, wb, ub, s0b, _, _ = wkv_inputs(*shape, device, 80 + Tb, dtype)
            check_fwd(rb, kb, vb, wb, ub, s0b if with_s0 else None,
                      f"{shape} {str(dtype)[6:]}{' s0' if with_s0 else ''}")
            n_fwd += 1
    x = torch.rand(r.shape, device=device, generator=torch.Generator(device=device).manual_seed(2))
    w_zero = torch.where(x < 0.3, torch.zeros_like(w), w)
    w_mixed = 0.985 + 0.01 * x
    w_mixed[:, torch.arange(T, device=device) % 64 < 30] = 1e-30
    check_fwd(r, k, v, w_zero, u, None, f"{MAIN_WKV} bf16 w with 30% exact zeros")
    # 1e-30 then ~0.99: held against wkv_ref in f64, as the near-1 cases are; the
    # f32 loop's reading of the same case, and the kernel's against that loop, beside it
    mixed = check_fwd(r, k, v, w_mixed, u, None, f"{MAIN_WKV} bf16 w 1e-30 in steps 0-29 of "
                      f"every 64, ~0.99 after, against f64", exact=True)
    n_fwd += 2
    exact_out, exact_s = wk.wkv_ref(*(t.double() for t in (r, k, v, w_mixed, u)))
    f32_out, f32_s = wk.wkv_ref(r, k, v, w_mixed, u)
    got_out, got_s = wk.wkv_fwd(r, k, v, w_mixed, u)
    # the kernels' chunked arithmetic in f32 torch ops on the same inputs: how much
    # of the kernel's reading its algorithm gives, apart from the card's 3xTF32
    # products and PTX approximations
    form_out, form_s = wk.ref.wkv_chunked_ref(r, k, v, w_mixed, u)

    def share(got, ref):
        return max(float(((a.double() - b.double()).abs() / (2e-4 + 2e-4 * b.double().abs())).max())
                   for a, b in zip(got, ref))

    mixed_f32 = share((f32_out, f32_s), (exact_out, exact_s))
    mixed_vs_loop = share((got_out, got_s), (f32_out, f32_s))
    mixed_form = share((form_out, form_s), (exact_out, exact_s))
    del exact_out, exact_s, f32_out, f32_s, got_out, got_s, form_out, form_s
    # near-1 decays: each step's log decay is ~1e-5, and an error in it adds up over
    # the whole walk.  The f32 sequential loop's own rounding adds up too, past the
    # gate from a few hundred steps on (printed below), so these cases are held at
    # the same gate against wkv_ref in f64: out and s_final at T 512 + 17, s_final
    # (which carries the whole walk's decay) at T 4096 + 17
    near1 = {}
    for Tn, state_only in ((512 + 17, False), (T + 17, True)):
        shape = (B, Tn, H, K)
        args = wkv_inputs(*shape, device, 81, torch.bfloat16, w_range=(0.9999, 0.99999))[:5]
        near1[Tn] = check_fwd(*args, None, f"{shape} bf16 w in (0.9999, 0.99999) against f64",
                              exact=True, state_only=state_only)
        n_fwd += 1
    exact_out, exact_s = wk.wkv_ref(*(t.double() for t in args))
    f32_out, f32_s = wk.wkv_ref(*args)
    f32_loop = max(float(((a - b).abs() / (2e-4 + 2e-4 * b.abs())).max())
                   for a, b in ((f32_out, exact_out), (f32_s, exact_s)))
    del args, exact_out, exact_s, f32_out, f32_s
    h = T // 2 + 17
    out_a, s_a = wk.wkv_fwd(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u)
    out_b, s_b = wk.wkv_fwd(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s_a)
    want_out, want_s = wk.wkv_ref(r, k, v, w, u)
    check_out(torch.cat([out_a, out_b], 1), s_b, want_out, want_s,
              f"{MAIN_WKV} split at T/2 + 17 through s_final -> s0")
    off_grid = max(float((torch.cat([out_a, out_b], 1) - out).abs().max()),
                   float((s_b - s_final).abs().max()))
    say(f"phase 1d: chunked wkv fwd within the gate on {n_fwd} more cases (T 1, 8, 9, 15, 16, "
        f"63, 64, 65, 4113 at K 64 bf16 and K 32 f32 + s0; exact-zero, 1e-30-then-0.99 and "
        f"near-1 decays) and split at T/2 + 17 (off the 64-step grid; {off_grid:.3e} from one "
        f"run); largest forward reading {gate['share']:.4f} of the gate |d| <= 2e-4 + "
        f"2e-4 |ref| ({gate['at']}); near-1 decays against f64: out and s_final at T 529 "
        f"{near1[512 + 17]:.4f}, s_final at T 4113 {near1[T + 17]:.4f} of the gate (the f32 "
        f"sequential loop's out and s_final at T 4113: {f32_loop:.4f}, not gated); "
        f"1e-30-then-0.99 against f64: the kernel {mixed:.4f}, the f32 loop {mixed_f32:.4f} "
        f"and the chunked form in f32 (wkv_chunked_ref) {mixed_form:.4f} (neither gated), the "
        f"kernel against the f32 loop {mixed_vs_loop:.4f} of the gate; "
        f"repeats bitwise equal")
    del w_zero, w_mixed, out_a, out_b, want_out, want_s

    # --- the chunked backward alone: the decays where dw through d(log w) / w went
    # wrong (small and exactly zero w), near-1 decays against f64, its boundaries
    w_extreme = 10.0 ** (-12.0 + 6.0 * x)
    w_mixed = 0.985 + 0.01 * x
    w_mixed[:, torch.arange(T, device=device) % 64 < 30] = 1e-30
    w_zero = torch.where(x < 0.3, torch.zeros_like(w), w)
    w_near1 = 0.9999 + 0.00009 * x
    n_bwd = 0
    for name, wd, exact in (("w 10^U(-12, -6)", w_extreme, False),
                            ("w 1e-30 in steps 0-29 of every 64, ~0.99 after", w_mixed, False),
                            ("w with 30% exact zeros", w_zero, False),
                            ("w in (0.9999, 0.99999) against f64", w_near1, True)):
        check_bwd((r, k, v, wd, u, None, dout, None), f"{MAIN_WKV} bf16 {name}", exact)
        n_bwd += 1
    del w_extreme, w_mixed, w_zero, w_near1, x
    for Tb in (1, 8, 9, 63, 64, 65, 4096 + 17):
        for shape, dtype, with_state in (((1, Tb, 8, K), torch.bfloat16, True),
                                         ((1, Tb, 4, 32), torch.float32, False)):
            rb, kb, vb, wb, ub, s0b, dob, dsb = wkv_inputs(*shape, device, 90 + Tb, dtype)
            check_bwd((rb, kb, vb, wb, ub, s0b if with_state else None, dob,
                       dsb if with_state else None),
                      f"{shape} {str(dtype)[6:]}{' s0/ds_final' if with_state else ''}")
            n_bwd += 1
    say(f"phase 1d: chunked wkv bwd within the gate on {n_bwd} more cases (at {MAIN_WKV} bf16 "
        f"w 10^U(-12, -6), 1e-30-then-0.99, 30% exact zeros, and near 1 against f64; T 1, 8, 9, "
        f"63, 64, 65, 4113 at K 64 bf16 + s0/ds_final and K 32 f32); largest gradient reading "
        f"{bgate['share']:.4f} of the gate |d| <= 2e-4 max(1, max|g|) ({bgate['at']}); no "
        f"value non-finite; the forward's chunk states handed over give the same bits; "
        f"repeats bitwise equal")

    # --- timing at the main path's shape, as the path calls them (bf16 r/k/v,
    # no s0, no ds_final; the backward given the forward's chunk states)
    elems, steps_states = B * T * H * K, B * T * H * K * K
    # bytes: each input read once, each output written once; operations per state
    # element per step: forward r·S (2) and S w + k v (3); backward the state (3),
    # dS (3), dS·k, dS·v, S·do, dS⊙S (2 each).  Both run their products in 3xTF32 on
    # the tensor cores (three TF32 passes each)
    work = {"fwd": ((3 * 2 + 4 + 4) * elems + 4 * H * K + 4 * B * H * K * K, 5 * steps_states),
            "bwd": ((3 * 2 + 4 + 4 + 4 * 4) * elems + 2 * 4 * H * K, 14 * steps_states)}
    states = wk.ops._wkv_fwd(r, k, v, w, u, None)[2]
    calls = {"fwd": (lambda: wk.wkv_fwd(r, k, v, w, u), lambda: wk.wkv_ref(r, k, v, w, u)),
             "bwd": (lambda: wk.wkv_bwd(r, k, v, w, u, None, dout, chunk_states=states),
                     lambda: wk.wkv_bwd_ref(r, k, v, w, u, None, dout))}
    timings = {}
    for name, (kern, plain) in calls.items():
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / (PEAK_FLOPS["tf32"] / 3) * 1e3
        timings[name] = t = {
            "ms": median_ms(kern), "device_ms": device_ms(kern),
            "plain_ms": median_ms(plain, reps=3, warmup=1),
            "library_ms": None, "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        say(f"phase 1d: wkv {name} {MAIN_WKV} bf16 r/k/v, one call: {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, library none (no PyTorch "
            f"call computes the WKV recurrence), {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"GFLOP, bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} "
            f"({t['bound_ms'] / t['ms'] * 100:.1f}% of bound); the same operations on the "
            f"f32 CUDA cores: {flops / PEAK_FLOPS['float32'] * 1e6:.2f} us"
            + (f"; without the forward's chunk states (its walk in the call) "
               f"{median_ms(lambda: wk.wkv_bwd(r, k, v, w, u, None, dout)):.4f} ms"
               if name == "bwd" else ""))
    del r, k, v, w, u, dout, out, states
    torch.cuda.empty_cache()
    wk.reset_counts()
    return errs, timings


# ---------------------------------------------------------------------------
# Phase 1e: flash at the attention shapes of StarCoder2, Gemma2, Mixtral, DBRX
# ---------------------------------------------------------------------------


def phase_new_flash(device):
    """The flash kernels at each new training cell's attention (``NEW_ATTN``),
    bf16: against their plain versions with phase 1b's tolerances, a second
    run bitwise equal, forward -> backward through the kernels' own (o, lse),
    then timed beside their bounds and SDPA (flex_attention at the softcap
    shapes).
    Returns {tag: (errs, timings)}."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    out = {}
    for i, (tag, shape) in enumerate(NEW_ATTN):
        errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        rel = {}
        opts = dict(causal=True, window=shape[6], softcap=shape[7])
        res = check_flash_case(shape, torch.bfloat16, device, 60 + i, errs, rel=rel)
        q, k, v, do = res["inputs"]
        o2 = fa.flash_attention_fwd(q, k, v, **opts)
        dq2 = fa.flash_attention_dq(q, k, v, do, res["want_lse"], res["delta"], **opts)
        dk2, dv2 = fa.flash_attention_dkv(q, k, v, do, res["want_lse"], res["delta"], **opts)
        for name, a, b in (("o", o2, res["o"]), ("dq", dq2, res["dq"]), ("dk", dk2, res["dk"]),
                           ("dv", dv2, res["dv"])):
            if not torch.equal(a, b):
                fail(f"flash {name} at {tag}'s attention: a second run gave other bits")
        del res, q, k, v, do, o2, dq2, dk2, dv2
        torch.cuda.empty_cache()
        fb = check_fwd_bwd(shape, device, 70 + i)
        torch.cuda.empty_cache()
        say(f"phase 1e: {tag}: flash fwd/dQ/dK-dV at {shape[:5]} window {shape[6]} softcap "
            f"{shape[7]} bf16 within tolerance of the plain versions (max |diff| fwd "
            f"{errs['fwd']:.3e}, dq {errs['dq']:.3e}, dkv {errs['dkv']:.3e}; max |diff| / "
            f"max|want| {fmt_rel(rel)}); repeated runs bitwise equal; fwd -> bwd through the "
            f"kernels' own (o, lse): max |diff| / max|g| {fmt_rel(fb)} (<= 1e-2)")
        out[tag] = (errs, time_flash(shape, device, 80 + i, f"phase 1e: {tag}", plain_reps=3))
    fa.reset_counts()
    return out


# ---------------------------------------------------------------------------
# Phase 2: the reduced model on the card against the CPU
# ---------------------------------------------------------------------------


def kernel_head_dim(cfg):
    """``cfg`` with a head dim the flash kernels take (32, 64, 128, 256): the
    reduced StarCoder2 and Qwen2-VL configs' 24 is raised to 32 (Qwen2-VL's
    M-RoPE sections, which sum to half of it, to (4, 6, 6))."""
    import dataclasses

    att = cfg.attention
    if att is None or att.head_dim != 24:
        return cfg
    sections = (4, 6, 6) if att.rope == "mrope" else att.mrope_sections
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        att, head_dim=32, mrope_sections=sections))


def phase_reduced_model(device, arch="tinyllama-1.1b", seq=64, tag="phase 2") -> None:
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.trainer import batch_to_device
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6_wkv as wk
    from repro_torch.models import Transformer
    from repro_torch.models.transformer import ATTN_KINDS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = kernel_head_dim(get_reduced(arch, param_dtype=torch.float32, attn_impl="flash"))
    batch = make_stream(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2,
                                   input_mode=cfg.input_mode, d_model=cfg.d_model)).batch_at(0)
    results = []
    cpu_model = Transformer(cfg, device="cpu", seed=0)
    fa.reset_counts()
    rg.reset_counts()
    wk.reset_counts()
    for dev in (torch.device("cpu"), device):
        model = cpu_model if dev.type == "cpu" else Transformer(cfg, device=dev, seed=None)
        if dev.type != "cpu":
            model.load_state_dict(cpu_model.state_dict())
        loss = model.loss(batch_to_device(batch, dev))
        loss.backward()
        results.append((float(loss.detach()),  # an unread table has no gradient
                        {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                         if p.grad is not None}))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results
    # each side once per layer (the forward twice: checkpointing reruns it):
    # the card through the kernels, the CPU through the plain versions
    kinds = cfg.block_kinds()
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    n_rec = kinds.count("rec")
    n_rwkv = kinds.count("rwkv")
    for fn, n in ((fa.flash_attention_fwd, 2 * n_attn), (fa.flash_attention_dq, n_attn),
                  (fa.flash_attention_dkv, n_attn), (rg.rglru_fwd, 2 * n_rec),
                  (rg.rglru_bwd, n_rec), (wk.wkv_fwd, 2 * n_rwkv), (wk.wkv_bwd, n_rwkv)):
        if (fn.launches, fn.ref_calls) != (n, n):
            fail(f"{tag}: {fn.__name__} launched {fn.launches} and took the plain version "
                 f"{fn.ref_calls} times, expected {n} each")
    fa.reset_counts()
    rg.reset_counts()
    wk.reset_counts()
    if not math.isfinite(l_gpu) or abs(l_gpu - l_cpu) > 1e-5 * abs(l_cpu):
        fail(f"{tag}: reduced loss on the card {l_gpu} vs CPU {l_cpu}")
    worst = 0.0
    if set(g_gpu) != set(g_cpu):
        fail(f"{tag}: gradients on the card {sorted(set(g_gpu) ^ set(g_cpu))} differ from the "
             f"CPU's set")
    for n, g in g_cpu.items():
        if g_gpu[n].shape != g.shape or not torch.isfinite(g_gpu[n]).all():
            fail(f"{tag}: gradient {n} has the wrong shape or is not finite")
        rel = float((g_gpu[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        worst = max(worst, rel)
        if rel > 1e-4:
            fail(f"{tag}: gradient {n}: max-abs error {rel:.3e} x max|g|")
    kernels = " and ".join(name for name, n in (("the flash kernels", n_attn),
                                                 ("the RG-LRU kernels", n_rec),
                                                 ("the WKV kernels", n_rwkv)) if n)
    say(f"{tag}: reduced {arch} fp32 with {kernels}: loss {l_gpu:.6f} (CPU {l_cpu:.6f}), "
        f"worst gradient error {worst:.3e} x max|g| over {len(g_cpu)} leaves")


# ---------------------------------------------------------------------------
# Phase 3: full-width training through the launcher
# ---------------------------------------------------------------------------


def phase_full_width(device):
    import torch
    from repro_torch.fabric.ops import issue
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.comm_pack import pack_arena, reset_counts, unpack_arena

    runs = [("post_f32", ["--issue-order", "post"]),
            ("post_f32_dots", ["--issue-order", "post"]),  # under DOTS
            ("dag_f32", ["--issue-order", "dag"]),
            ("post_bf16_ef", ["--issue-order", "post", "--compression", "bf16_ef"]),
            ("post_f32_plain_attn", ["--issue-order", "post", "--attn-impl", "plain"])]
    # every launch counter to 0 just before the main path, read just after
    reset_counts()
    fa.reset_counts()
    issue.calls = 0
    post_params, post_losses, groups, steps, flash_steps = None, None, None, 0, 0
    step_ms, peak = {}, {}
    for name, extra in runs:
        res = train(f"phase3_{name}", TRAIN_ARGS + extra,
                    overrides=DOTS if name.endswith("_dots") else None)
        n_groups = res.engine.sync.n_groups
        groups = n_groups if groups is None else groups
        if n_groups != groups:
            fail(f"{name}: {n_groups} groups, expected {groups}")
        steps += len(res.losses)
        if "plain" not in name:
            flash_steps += len(res.losses)
        if not all(math.isfinite(x) for x in res.losses):
            fail(f"{name}: non-finite loss {res.losses}")
        step_s = statistics.median(res.step_seconds[1:])
        step_ms[name] = step_s * 1e3
        peak_gib = (res.peak_memory_bytes or 0) / 2**30
        peak[name] = peak_gib
        say(f"phase 3: {name}: losses {[round(x, 4) for x in res.losses]}, step "
            f"{step_s * 1e3:.1f} ms (median of steps 2-3), {res.tokens_per_step / step_s:,.0f} "
            f"tokens/s, peak memory {peak_gib:.2f} GiB, {n_groups} groups")
        # kept on the host, so the next run's peak memory is its own
        params = {n: p.detach().cpu() for n, p in res.model.named_parameters()}
        if name == "post_f32":
            post_params, post_losses = params, res.losses
        elif name == "post_f32_dots":
            same_as_post("phase 3", res.losses, params, post_losses, post_params, "dots")
            say(f"phase 3: dots step {step_ms[name]:.1f} ms against full {step_ms['post_f32']:.1f} "
                f"ms; peak {peak_gib:.2f} GiB against full {peak['post_f32']:.2f} GiB")
        elif name == "dag_f32":
            dag = {"losses": res.losses, "step_ms": step_ms[name]}
            same_as_post("phase 3", res.losses, params, post_losses, post_params, "dag")
            post_params = None
        elif name == "post_f32_plain_attn":
            gap = abs(res.losses[0] - post_losses[0])
            if gap > 1e-2:
                fail(f"first-step loss with the flash kernels {post_losses[0]} vs plain "
                     f"attention {res.losses[0]}: differ by {gap} > 1e-2")
            say(f"phase 3: post step with the flash kernels {step_ms['post_f32']:.1f} ms, with "
                f"plain attention {step_ms[name]:.1f} ms; first-step losses {post_losses[0]:.6f} "
                f"vs {res.losses[0]:.6f} (|diff| {gap:.3e} <= 1e-2)")
        del res, params
        torch.cuda.empty_cache()
    counts = {
        "pack_launches": pack_arena.launches,
        "unpack_launches": unpack_arena.launches,
        "pack_plain_calls": pack_arena.ref_calls,
        "unpack_plain_calls": unpack_arena.ref_calls,
        "issue_calls": issue.calls,
        "expected": groups * steps,
    }
    if not (counts["pack_launches"] == counts["unpack_launches"] == counts["issue_calls"]
            == groups * steps) or counts["pack_plain_calls"] or counts["unpack_plain_calls"]:
        fail(f"launch counts {counts}: expected {groups} groups x {steps} steps")
    say(f"phase 3: pack {counts['pack_launches']}, unpack {counts['unpack_launches']}, "
        f"issue() {counts['issue_calls']} = {groups} groups x {steps} steps")
    want = {"fwd": 2 * N_LAYERS * flash_steps, "dq": N_LAYERS * flash_steps,
            "dkv": N_LAYERS * flash_steps}
    for name, fn in (("fwd", fa.flash_attention_fwd), ("dq", fa.flash_attention_dq),
                     ("dkv", fa.flash_attention_dkv)):
        counts[f"flash_{name}_launches"] = fn.launches
        if fn.launches != want[name] or fn.ref_calls:
            fail(f"flash {name}: {fn.launches} launches and {fn.ref_calls} plain calls, expected "
                 f"{want[name]} launches over {flash_steps} flash steps and no plain call")
    say(f"phase 3: flash fwd {want['fwd']} (2 x {N_LAYERS} layers x {flash_steps} steps: "
        f"checkpointing reruns each forward), dQ {want['dq']}, dK/dV {want['dkv']} launches, "
        f"0 plain calls")
    return counts, dag


def same_as_post(tag, losses, params, post_losses, post_params, name) -> None:
    """Fails unless a run's losses and parameters are bitwise the ``post``
    run's."""
    import torch

    if losses != post_losses:
        fail(f"{tag}: {name} losses {losses} != post losses {post_losses}")
    for n, p in params.items():
        if not torch.equal(p, post_params[n]):
            fail(f"{tag}: {name} parameter {n} differs from post")
    say(f"{tag}: {name} parameters and losses bitwise equal to post")


def reckon_bytes(model, optimizer: str) -> int:
    """Static bytes of a training run, reckoned before it: each parameter
    and its gradient in the parameter's dtype, AdamW's two f32 moments
    (plain SGD keeps none) and the f32 wire arenas (4 B a parameter)."""
    total = 0
    for p in model.parameters():
        state = 8 if optimizer == "adamw" else 0
        total += p.numel() * (2 * p.element_size() + state + 4)
    return total


def train_cell(tag, label, args, overrides, per_step, dots=False):
    """One training cell through the launcher: ``post`` then ``dag``, 3 steps
    each from the same weights, and with ``dots`` a ``post`` run under
    ``remat='dots'`` between them.  Held: finite losses, ``dag`` (and
    ``dots``) bitwise equal to ``post``, pack / unpack / ``issue()`` = groups x steps, and each
    kernel wrapper of ``per_step`` ({name: (wrapper, launches a step)})
    launched that many times a step, with no plain call; a parameter the loss
    does not read (``unread_params``: an embeds arch's table) ends each run
    with an exactly zero gradient.  Prints each run's
    step time, peak memory (``torch.cuda.max_memory_allocated``) beside the
    reckoned static bytes, and groups.  Returns the counts
    (``pack_launches``, ..., ``<name>_launches``) and the ``dag`` run's
    result."""
    import torch
    from repro_torch.core.trainer import unread_params
    from repro_torch.fabric.ops import issue
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6_wkv as wk
    from repro_torch.kernels.comm_pack import pack_arena, reset_counts, unpack_arena

    optimizer = _arg(args, "--optimizer") if "--optimizer" in args else "adamw"
    # every launch counter to 0 just before the main path, read just after
    reset_counts()
    fa.reset_counts()
    rg.reset_counts()
    wk.reset_counts()
    issue.calls = 0
    post_params, post_losses, groups, steps = None, None, None, 0
    for name in ("post", "dots", "dag") if dots else ("post", "dag"):
        order = "dag" if name == "dag" else "post"
        res = train(f"{tag.replace(' ', '')}_{name}", args + ["--issue-order", order],
                    overrides={**overrides, **DOTS} if name == "dots" else overrides)
        n_groups = res.engine.sync.n_groups
        groups = n_groups if groups is None else groups
        if n_groups != groups:
            fail(f"{tag} {name}: {n_groups} groups, expected {groups}")
        steps += len(res.losses)
        if not all(math.isfinite(x) for x in res.losses):
            fail(f"{tag} {name}: non-finite loss {res.losses}")
        step_s = statistics.median(res.step_seconds[1:])
        n_params = sum(p.numel() for p in res.model.parameters())
        run_name = "post_f32_dots" if name == "dots" else f"{name}_f32"
        say(f"{tag}: {label} {run_name} ({optimizer}): losses {[round(x, 4) for x in res.losses]}, "
            f"step {step_s * 1e3:.1f} ms (median of steps 2-3), "
            f"{res.tokens_per_step / step_s:,.0f} tokens/s, peak memory "
            f"{(res.peak_memory_bytes or 0) / 2**30:.2f} GiB (static + arenas reckoned "
            f"{reckon_bytes(res.model, optimizer) / 1e9:.1f} GB over {n_params / 1e9:.3f} B "
            f"parameters), {n_groups} groups")
        for n in unread_params(res.model.cfg):
            # the table the loss does not read: its reduced gradient (unpacked into .grad)
            # is an exact zero, as jax.grad gives it
            g = res.model.get_parameter(n).grad
            if g is None or int(torch.count_nonzero(g)):
                fail(f"{tag} {name}: {n}'s gradient is "
                     f"{'missing' if g is None else 'not exactly zero'}")
            say(f"{tag} {name}: {n}'s gradient exactly zero ({g.numel():,} elements), reduced "
                f"through its group's all-reduce")
        params = {n: p.detach().cpu() for n, p in res.model.named_parameters()}
        if name == "post":
            post_params, post_losses = params, res.losses
        else:
            same_as_post(tag, res.losses, params, post_losses, post_params, name)
        if name == "dag":
            kept = res  # probed after the counts are read
        del res, params
        torch.cuda.empty_cache()
    counts = {
        "pack_launches": pack_arena.launches, "unpack_launches": unpack_arena.launches,
        "issue_calls": issue.calls,
    }
    if not (counts["pack_launches"] == counts["unpack_launches"] == counts["issue_calls"]
            == groups * steps) or pack_arena.ref_calls or unpack_arena.ref_calls:
        fail(f"{tag}: launch counts {counts}: expected {groups} groups x {steps} steps")
    for name, (fn, n) in per_step.items():
        counts[f"{name}_launches"] = fn.launches
        if hasattr(fn, "windowed_launches"):  # the flash wrappers
            counts[f"{name}_windowed_launches"] = fn.windowed_launches
        if fn.launches != n * steps or fn.ref_calls:
            fail(f"{tag}: {name}: {fn.launches} launches and {fn.ref_calls} plain calls, "
                 f"expected {n} a step x {steps} steps and no plain call")
    say(f"{tag}: pack {counts['pack_launches']}, unpack {counts['unpack_launches']}, issue() "
        f"{counts['issue_calls']} = {groups} groups x {steps} steps; "
        + ", ".join(f"{name} {counts[name + '_launches']} ({n} a step)"
                    for name, (_, n) in per_step.items()) + "; 0 plain calls")
    return counts, kept


def phase_rg_full_width(device):
    """Full-width RecurrentGemma-9B at 8 layers: 6 RG-LRU layers (each
    forward twice under checkpointing) and 2 attention layers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg

    per_step = {"rglru_fwd": (rg.rglru_fwd, 2 * RG_REC_LAYERS),
                "rglru_bwd": (rg.rglru_bwd, RG_REC_LAYERS),
                "flash_fwd": (fa.flash_attention_fwd, 2 * RG_ATTN_LAYERS),
                "flash_dq": (fa.flash_attention_dq, RG_ATTN_LAYERS),
                "flash_dkv": (fa.flash_attention_dkv, RG_ATTN_LAYERS)}
    counts, kept = train_cell("phase 3b", "recurrentgemma-9b x 8 layers", RG_ARGS, RG_DEPTH,
                              per_step, dots="phase 3b" in DOTS_CELLS)
    probe_pass("phase 3b", kept, RG_ARGS)
    return counts


def phase_rwkv_full_width(device):
    """Full-width RWKV6-7B at 8 layers: 8 WKV layers (each forward twice
    under checkpointing), no attention and no RG-LRU."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6_wkv as wk

    per_step = {"wkv_fwd": (wk.wkv_fwd, 2 * RWKV_LAYERS), "wkv_bwd": (wk.wkv_bwd, RWKV_LAYERS),
                "flash_fwd": (fa.flash_attention_fwd, 0), "rglru_fwd": (rg.rglru_fwd, 0)}
    counts, kept = train_cell("phase 3c", f"rwkv6-7b x {RWKV_LAYERS} layers", RWKV_ARGS,
                              {"n_layers": RWKV_LAYERS}, per_step, dots="phase 3c" in DOTS_CELLS)
    probe_pass("phase 3c", kept, RWKV_ARGS)
    return counts


def phase_new_full_width(device):
    """Phases 3d-3j: the full-width cells of ``NEW_CELLS``, one after the
    other, each freed before the next; every layer attends (flash fwd
    twice a layer and step under checkpointing, dQ and dK/dV once), and the
    layers with a window (``window_for``) make the windowed share of those
    launches.  Returns {arch: counts}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6_wkv as wk
    from repro_torch.models.transformer import ATTN_KINDS, window_for

    out = {}
    for tag, arch, depth, extra in NEW_CELLS:
        cfg = get_config(arch, **depth)
        n_attn = sum(k in ATTN_KINDS for k in cfg.block_kinds())
        n_win = sum(k in ATTN_KINDS and window_for(cfg, k) is not None
                    for k in cfg.block_kinds())
        per_step = {"flash_fwd": (fa.flash_attention_fwd, 2 * n_attn),
                    "flash_dq": (fa.flash_attention_dq, n_attn),
                    "flash_dkv": (fa.flash_attention_dkv, n_attn),
                    "rglru_fwd": (rg.rglru_fwd, 0), "wkv_fwd": (wk.wkv_fwd, 0)}
        args = ["--arch", arch, "--steps", "3", "--fuse", "arena", "--policy", "mg_wfbp",
                "--fabric", "gpu_nccl"] + extra
        label = f"{arch} x {cfg.n_layers} layers"
        out[arch], kept = train_cell(tag, label, args, depth, per_step, dots=tag in DOTS_CELLS)
        del kept
        c = out[arch]
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            if c[f"{name}_windowed_launches"] * n_attn != c[f"{name}_launches"] * n_win:
                fail(f"{tag}: {name}: {c[name + '_windowed_launches']} of "
                     f"{c[name + '_launches']} launches with a window, expected "
                     f"{n_win} of every {n_attn}")
        say(f"{tag}: flash launches with a window: fwd {c['flash_fwd_windowed_launches']}, dQ "
            f"{c['flash_dq_windowed_launches']}, dK/dV {c['flash_dkv_windowed_launches']} "
            f"({n_win} of {n_attn} attention layers)")
        torch.cuda.empty_cache()
    return out


def _arg(args, flag):
    return args[args.index(flag) + 1]


def probe_batch(args, vocab, device):
    """Step 0's batch of a run with launcher flags ``args``."""
    from repro_torch.core.trainer import batch_to_device
    from repro_torch.data import DataConfig, make_stream

    data = make_stream(DataConfig(vocab=vocab, seq_len=int(_arg(args, "--seq")),
                                  global_batch=int(_arg(args, "--batch"))))
    return batch_to_device(data.batch_at(0), device)


def probe_pass(tag, res, args):
    """One ``probe_unit_times`` pass over a trained model: every unit of the
    plan's layout covered, each finite and > 0; the kernels the probes
    launch are counted apart from the training steps'."""
    from repro_torch.kernels import launch_counts
    from repro_torch.runtime import probe_unit_times

    model, layout = res.model, res.engine.plan.layout
    batch = probe_batch(args, model.cfg.vocab, model.embed.device)
    before = launch_counts()
    prof = probe_unit_times(model.cfg, model, batch, layout)  # synchronizes the card
    launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    units = [u.name for u in layout.units]
    bad = [u for u in units if not (math.isfinite(prof.unit_seconds.get(u, math.nan))
                                    and prof.unit_seconds[u] > 0)]
    if bad or sorted(prof.unit_seconds) != sorted(units):
        fail(f"{tag}: probe pass covers {sorted(prof.unit_seconds)} of {units}; bad {bad}")
    kinds = {}
    for u in units:
        kinds.setdefault("stage" if u.startswith("stage_") else u, prof.unit_seconds[u])
    say(f"{tag}: probe pass, backward seconds (2/3 of fwd+bwd, min of 2) by unit kind: "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in kinds.items())
        + f"; all {len(units)} units covered and finite; probe launches (apart from the "
        f"steps'): {launched}")
    return prof


# ---------------------------------------------------------------------------
# Phase 4: the measured-cost loop through the launcher
# ---------------------------------------------------------------------------


def phase_autotune(device, dag):
    """TinyLlama-1.1B at full width through ``run`` with ``--measure-comm
    --autotune``, re-planning and (α, β) re-fits every 4 steps, 8 ``dag``
    steps, beside an 8-step ``dag`` run on phase 3's plan; then ``--dryrun
    3`` under the span recorder.  ``dag`` holds phase 3's ``dag`` run
    (losses, step ms).  Returns the launches of the tuned run's steps and
    what phase 9 prices on: the startup probe, the (α, β) fit, the adopted
    plan and the last tuner record's predicted and observed t_iter."""
    import torch
    from repro_torch.core.cost_model import TPU_V5E
    from repro_torch.core.profiler import overlap_report, parse_trace_spans, time_segment
    from repro_torch.core.trainer import lm_unit_costs
    from repro_torch.fabric.ops import issue
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6_wkv as wk
    from repro_torch.kernels.comm_pack import pack_arena, reset_counts, unpack_arena
    from repro_torch.models import param_shapes
    from repro_torch.planning import default_policies
    from repro_torch.runtime import BWD_FRACTION, make_unit_probes

    t0 = time.perf_counter()
    # the same 8 steps on phase 3's plan, never re-planned
    plain = train("phase4_plain", TRAIN_ARGS + ["--issue-order", "dag", "--steps", "8"])
    plain_losses, plain_ms = plain.losses, [t * 1e3 for t in plain.step_seconds]
    del plain
    torch.cuda.empty_cache()
    # every launch counter to 0 just before the main path, read just after
    reset_counts()
    fa.reset_counts()
    rg.reset_counts()
    wk.reset_counts()
    issue.calls = 0
    res = train("phase4", P4_ARGS)
    totals = launch_counts()
    totals["issue"] = issue.calls
    ref_calls = {fn.__name__: fn.ref_calls for fn in (
        pack_arena, unpack_arena, fa.flash_attention_fwd, fa.flash_attention_dq,
        fa.flash_attention_dkv)}
    layout = res.plan.layout
    units = [u.name for u in layout.units]
    hist = res.tuner_history
    first = hist[0] if hist else None
    swept = sorted(c.policy for c in first.candidates) if first else []
    if not first or first.trigger != "startup" or swept != sorted(default_policies(len(units))):
        fail(f"phase 4: startup sweep scored {swept}, expected every policy of "
             f"default_policies({len(units)}) = {default_policies(len(units))}")
    prof = res.unit_profiles[0]
    if sorted(prof.unit_seconds) != sorted(units) or not all(
            math.isfinite(v) and v > 0 for v in prof.unit_seconds.values()):
        fail(f"phase 4: unit seconds {prof.unit_seconds} do not cover the {len(units)} units "
             f"finite and > 0")
    fit = res.comm_model
    if not (math.isfinite(fit.a) and math.isfinite(fit.b) and fit.a >= 0 and fit.b >= 0):
        fail(f"phase 4: (α, β) fit {fit} not finite and >= 0")
    if len(res.losses) != 8 or not all(math.isfinite(x) for x in res.losses):
        fail(f"phase 4: losses {res.losses}")
    if res.losses[:3] != dag["losses"]:
        fail(f"phase 4: first losses {res.losses[:3]} != phase 3's dag {dag['losses']} (bitwise)")
    if res.losses != plain_losses:
        fail(f"phase 4: losses {res.losses} != the unbroken dag run's {plain_losses} (bitwise)")
    want = {"flash_attention_fwd": 2 * N_LAYERS, "flash_attention_dq": N_LAYERS,
            "flash_attention_dkv": N_LAYERS}
    for i, (g, got) in enumerate(zip(res.step_groups, res.step_launches)):
        per = {"pack_arena": g, "unpack_arena": g, "issue": g, **want}
        if any(got.get(k, 0) != n for k, n in per.items()):
            fail(f"phase 4 step {i}: launches {got}, expected {per} under a {g}-group plan")
    if any(ref_calls.values()):
        fail(f"phase 4: plain calls {ref_calls}")
    steps = {k: sum(d.get(k, 0) for d in res.step_launches) for k in totals}
    probes = {k: totals[k] - steps[k] for k in totals if totals[k] != steps[k]}
    if probes.get("issue") or probes.get("pack_arena") or probes.get("unpack_arena"):
        fail(f"phase 4: the probes or sweeps went through issue() or packed: {probes}")
    say(f"phase 4: {len(res.losses)} steps, losses {[round(x, 4) for x in res.losses]}; first "
        f"three bitwise equal to phase 3's dag, all eight to an unbroken 8-step dag run on "
        f"phase 3's plan; groups per step {res.step_groups}; every step "
        f"pack = unpack = issue() = its plan's groups, flash fwd / dQ / dK-dV 44 / 22 / 22, 0 "
        f"plain calls; the probes' and sweeps' own launches, apart: {probes}")
    say(f"phase 4: measured (α, β) at world 1: α = {fit.a:.4e} s, β = {fit.b:.4e} s/B "
        f"({fit.name}); the startup sweep's candidates (policy, groups, predicted t_iter): "
        + ", ".join(f"{c.policy} {c.n_groups} {c.predicted_t_iter * 1e3:.3f} ms"
                    for c in first.candidates))
    base = lm_unit_costs(res.model.cfg, param_shapes(res.model.cfg),
                         int(_arg(P4_ARGS, "--batch")) * int(_arg(P4_ARGS, "--seq")))
    ratios = prof.ratios(base, TPU_V5E)
    batch = probe_batch(P4_ARGS, res.model.cfg.vocab, device)
    probe_fns = make_unit_probes(res.model.cfg, res.model, batch)
    timed = []
    for kind, unit in (("embed", "embed"), ("stage", "stage_0"), ("head", "head")):
        fn, args = probe_fns[kind]
        wall = time_segment(fn, *args, warmup=1, repeats=3, device=device) * 1e3
        dev = device_ms(lambda fn=fn, args=args: fn(*args), calls=5)
        timed.append(f"{kind} {prof.unit_seconds[unit] * 1e3:.4f} ms ({ratios[unit]:.3g}x the "
                     f"TPU-v5e analytic t_b {base[units.index(unit)].t_b(TPU_V5E) * 1e3:.4f} ms;"
                     f" fwd+bwd {wall:.4f} ms wall, {dev:.4f} ms device)")
    say(f"phase 4: probe seconds (backward, {BWD_FRACTION:.3f} of fwd+bwd): " + "; ".join(timed)
        + f"; nonuniformity {prof.nonuniformity(base, TPU_V5E):.4g}")
    last = hist[-1]
    # what phase 9 prices the what-if on: the startup probe's unit seconds, the (α, β) fit,
    # the adopted plan and the last tuner record's predicted and observed t_iter
    sim_inputs = {"profile": prof, "fit": fit, "plan": res.plan, "cfg": res.model.cfg,
                  "tokens": int(_arg(P4_ARGS, "--batch")) * int(_arg(P4_ARGS, "--seq")),
                  "predicted": last.predicted_t_iter, "observed": last.observed_t_iter}
    tuned_ms = statistics.median(res.step_seconds[1:]) * 1e3
    say(f"phase 4: step ms, tuned run: {[round(t * 1e3, 1) for t in res.step_seconds]}; the "
        f"unbroken dag run on phase 3's plan: {[round(t, 1) for t in plain_ms]} (median of "
        f"steps 2-8 {statistics.median(plain_ms[1:]):.1f} ms)")
    say(f"phase 4: sweeps {[(r.trigger, r.chosen) for r in hist]}; adopted "
        f"{res.plan.policy}, {len(res.plan.schedule.groups)} groups "
        f"{list(res.plan.schedule.groups)}; predicted t_iter "
        f"{last.predicted_t_iter * 1e3:.3f} ms, observed "
        + (f"{last.observed_t_iter * 1e3:.3f} ms" if last.observed_t_iter else "none")
        + f"; step {tuned_ms:.1f} ms (median of steps 2-8) against phase 3's dag "
        f"{dag['step_ms']:.1f} ms")
    del res, probe_fns
    torch.cuda.empty_cache()

    TRACE_OUT.parent.mkdir(parents=True, exist_ok=True)
    res = train("phase4_dryrun", P4_ARGS + ["--dryrun", "3", "--trace-out", str(TRACE_OUT)])
    rep, groups = res.report, res.engine.sync.n_groups
    spans = parse_trace_spans(TRACE_OUT)
    if rep["n_comm_spans"] != groups * 2 or rep["n_bwd_spans"] <= 0 \
            or overlap_report(spans)["n_comm_spans"] != rep["n_comm_spans"]:
        fail(f"phase 4 dryrun: {rep['n_comm_spans']} comm spans for {groups} groups x 2 steps, "
             f"{rep['n_bwd_spans']} bwd spans, {len(spans)} spans read back")
    say(f"phase 4 dryrun: {groups} groups, overlap report "
        + json.dumps({k: rep[k] for k in ("n_comm_spans", "n_bwd_spans", "total_comm_us",
                                          "windowed_comm_us", "hidden_comm_us",
                                          "overlap_fraction", "hidden_fraction",
                                          "n_overlapped_starts")})
        + f"; {len(spans)} spans read back from {TRACE_OUT.relative_to(ROOT)}")
    del res
    torch.cuda.empty_cache()
    say(f"phase 4: {time.perf_counter() - t0:.1f} s")
    return steps, sim_inputs


# ---------------------------------------------------------------------------
# Phase 5: checkpoint and restart at full width
# ---------------------------------------------------------------------------


def phase_restart(device):
    """TinyLlama-1.1B at full width through ``run`` with ``--compression
    bf16_ef --issue-order dag``, 5 AdamW steps: an unbroken run, then one
    whose fault injector raises before step 4, after the checkpoint at step
    3, so that the loop restores it and replays step 3.  Then the int8
    wire (``compressed_psum_rs_ag``) on a one-rank NCCL group against its
    plain version on the CPU."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import available_steps
    from repro_torch.fabric.ops import issue
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.comm_pack import pack_arena, reset_counts, unpack_arena
    from repro_torch.launch.train import run
    from repro_torch.runtime import compressed_psum_rs_ag, compressed_psum_rs_ag_ref

    t0 = time.perf_counter()
    args = TRAIN_ARGS + ["--compression", "bf16_ef", "--issue-order", "dag", "--steps", "5"]
    dirs = {tag: CKPT_ROOT / f"phase5_{tag}" for tag in ("plain", "broken")}
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CKPT_ROOT).free
    fired = []

    def inject(step):
        if step == 4 and not fired:
            fired.append(step)
            raise RuntimeError("injected fault before step 4")

    try:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
        # every launch counter to 0 just before the main path, read just after
        reset_counts()
        fa.reset_counts()
        issue.calls = 0
        plain = run(args + ["--ckpt-dir", str(dirs["plain"]), "--ckpt-every", "100"], quiet=True)
        for p in plain.model.parameters():
            p.grad = None  # kept on the card for the comparison, without its gradients
        broken = run(args + ["--ckpt-dir", str(dirs["broken"]), "--ckpt-every", "3",
                             "--max-restarts", "1"], quiet=True, fault_injector=inject)
        totals = launch_counts()
        totals["issue"] = issue.calls
        ref_calls = {fn.__name__: fn.ref_calls for fn in (
            pack_arena, unpack_arena, fa.flash_attention_fwd, fa.flash_attention_dq,
            fa.flash_attention_dkv)}

        if (plain.restarts, broken.restarts) != (0, 1) or fired != [4]:
            fail(f"phase 5: restarts {plain.restarts} / {broken.restarts}, expected 0 / 1")
        steps = available_steps(dirs["broken"])
        step_dir = dirs["broken"] / "step_00000003"
        if steps != [3] or broken.checkpoint_steps != [3] or not (step_dir / "plan.json").exists() \
                or available_steps(dirs["plain"]):
            fail(f"phase 5: checkpoints {steps} ({broken.checkpoint_steps} saved), expected "
                 f"step_00000003 with plan.json alone")
        if len(plain.losses) != 5 or broken.losses != plain.losses \
                or not all(math.isfinite(x) for x in plain.losses):
            fail(f"phase 5: losses {broken.losses} != the unbroken run's {plain.losses} (bitwise)")
        if broken.replayed_losses != [(3, broken.losses[3])] \
                or broken.step_indices != [0, 1, 2, 3, 3, 4]:
            fail(f"phase 5: replayed {broken.replayed_losses} over steps {broken.step_indices}")
        a, b = plain.state, broken.state
        if a.opt_state.step != b.opt_state.step or a.opt_state.step != 5:
            fail(f"phase 5: AdamW step count {b.opt_state.step} vs {a.opt_state.step}")
        for kind, x, y in (("parameter", a.params, b.params), ("first moment", a.opt_state.m,
                           b.opt_state.m), ("second moment", a.opt_state.v, b.opt_state.v),
                           ("residual", a.residual, b.residual)):
            for n in x:
                if not torch.equal(x[n], y[n]):
                    fail(f"phase 5: {kind} {n} differs from the unbroken run's")
        want = {"flash_attention_fwd": 2 * N_LAYERS, "flash_attention_dq": N_LAYERS,
                "flash_attention_dkv": N_LAYERS}
        for tag, res in (("unbroken", plain), ("broken", broken)):
            for i, g, got in zip(res.step_indices, res.step_groups, res.step_launches):
                per = {"pack_arena": g, "unpack_arena": g, "issue": g, **want}
                if any(got.get(k, 0) != n for k, n in per.items()):
                    fail(f"phase 5 {tag} step {i}: launches {got}, expected {per}")
        if any(ref_calls.values()):
            fail(f"phase 5: plain calls {ref_calls}")
        counts = {k: sum(d.get(k, 0) for r in (plain, broken) for d in r.step_launches)
                  for k in totals}
        if counts != totals:
            fail(f"phase 5: launches outside the steps: {totals} against the steps' {counts}")

        ck_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        save, restore = broken.checkpoint_records
        others = [t for i, t in zip(broken.step_indices, broken.step_seconds)
                  if i not in (0, 3)]
        during = broken.step_seconds[broken.step_indices.index(3)]
        groups = broken.step_groups[0]
        say(f"phase 5: free disk before the phase {free / 1e9:.2f} GB; unbroken and broken "
            f"runs ({groups} groups, bf16_ef, dag, AdamW): losses "
            f"{[round(x, 4) for x in plain.losses]}, bitwise equal step by step, the replayed "
            f"step 3 too; restarts 0 / 1; one checkpoint, step_00000003 with plan.json; final "
            f"parameters, both AdamW moments, AdamW's step count ({b.opt_state.step}) and the "
            f"residual bitwise equal; every step, the replayed one included, pack = unpack = "
            f"issue() = {groups}, flash fwd / dQ / dK-dV 44 / 22 / 22, 0 plain calls")
        say(f"phase 5: checkpoint {ck_bytes} bytes on disk ({save['bytes']} of tensors); "
            f"synchronous snapshot to host {save['snapshot_s']:.3f} s, background write "
            f"{save['write_s']:.3f} s, restore {restore['seconds']:.3f} s; step 3's first run "
            f"(beside the background write) {during * 1e3:.1f} ms against the median of steps "
            f"1, 2, 4 {statistics.median(others) * 1e3:.1f} ms; step ms "
            f"{[(i, round(t * 1e3, 1)) for i, t in zip(broken.step_indices, broken.step_seconds)]}")
        del plain, broken, a, b
        torch.cuda.empty_cache()
    finally:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)

    # the int8 wire on a one-rank NCCL group, against its plain version on the CPU
    store_dir = CKPT_ROOT / "phase5_pg"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store_dir / "store"), 1), rank=0,
                            world_size=1)
    try:
        gen = torch.Generator(device=device).manual_seed(5)
        g = torch.randn(32000, 2048, generator=gen, device=device).to(torch.bfloat16)
        r = 1e-3 * torch.randn(32000, 2048, generator=gen, device=device)
        before = issue.calls
        full, res = compressed_psum_rs_ag(g, None, r)
        torch.cuda.synchronize()
        calls = issue.calls - before
        (want_full,), (want_res,) = compressed_psum_rs_ag_ref([g.cpu()], [r.cpu()])
        if calls != 3 or not torch.equal(full.cpu(), want_full) \
                or not torch.equal(res.cpu(), want_res):
            fail(f"phase 5: compressed_psum_rs_ag at NCCL world 1: {calls} issue() calls, "
                 f"max |diff| {float((full.cpu() - want_full).abs().max()):.3e} from the plain "
                 f"version")
        say(f"phase 5: compressed_psum_rs_ag (32000, 2048) bf16 + f32 residual on a one-rank "
            f"NCCL group: 3 issue() calls (reduce-scatter, two all-gathers), sum and residual "
            f"bitwise equal to the plain version on the CPU")
        del g, r, full, res
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    say(f"phase 5: {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 6: the serving path at full depth
# ---------------------------------------------------------------------------


def serve_lens(n, lo, hi, exact=None):
    """``n`` prompt lengths drawn from seed 0 in [lo, hi]; the first two are
    equal (the batched == solo pair) and, with ``exact``, the last is it."""
    import numpy as np

    lens = [int(x) for x in np.random.default_rng(0).integers(lo, hi + 1, size=n)]
    lens[1] = lens[0]
    if exact is not None:
        lens[-1] = exact
    return lens


# tag, arch, slots, max_seq, prompt lengths (from seed 0), new tokens
SERVE_CELLS = [
    ("phase 6a", "tinyllama-1.1b", 8, 1024, serve_lens(16, 64, 512), 128),
    ("phase 6b", "recurrentgemma-9b", 4, 4096, serve_lens(8, 256, 2304, exact=2304), 64),
    ("phase 6c", "rwkv6-7b", 4, 4096, serve_lens(8, 256, 2048), 64),
    ("phase 6d", "musicgen-large", 8, 1024, serve_lens(16, 64, 512), 128),
    ("phase 6e", "qwen2-vl-2b", 8, 1024, serve_lens(16, 64, 512), 128),
    ("phase 6f", "starcoder2-3b", 8, 1024, serve_lens(16, 64, 512), 128),
    ("phase 6g", "starcoder2-7b", 8, 1024, serve_lens(16, 64, 512), 128),
    ("phase 6h", "gemma2-2b", 8, 1024, serve_lens(16, 64, 512), 128),
    ("phase 6i", "mixtral-8x7b", 4, 1024, serve_lens(8, 64, 512), 64),
    ("phase 6j", "dbrx-132b", 4, 1024, serve_lens(8, 64, 512), 64),
]
#: The serving cells cut in depth: the deepest whose bf16 weights and f32 cache arena,
#: reckoned before the run (``reckon_serve_bytes``), stay within ``SERVE_STATIC_BUDGET``
SERVE_CUT_ARCHS = ("mixtral-8x7b", "dbrx-132b")
#: 70 GB of peak less ~6 GB for the prefills' activations, a second engine's arena, the
#: graph's pool and the allocator's slack
SERVE_STATIC_BUDGET = 64e9
#: The cells whose eager decode step is also profiled (6c and the MoE cells' eager steps are
#: not: the script's time limit)
SERVE_EAGER_PROFILE = ("phase 6a", "phase 6b", "phase 6d", "phase 6e", "phase 6f")
SERVE_SOLO_TOKENS = 16  # the batched == solo pair's tokens
SERVE_REDUCED_STEPS = 8
RG_SERVE_ATTN = (1, 2304, 16, 1, 256, True, 2048, None)  # 6b's longest prefill, one layer
TL_SERVE_ATTN = (1, 512, 32, 4, 64, True, None, None)  # 6a's longest prefill, one layer
MG_SERVE_ATTN = (1, 512, 32, 32, 64, True, None, None)  # 6d's, MHA
QW_SERVE_ATTN = (1, 512, 12, 2, 128, True, None, None)  # 6e's, GQA 6:1
#: Each serving cell with attention: its tag, the key of its B3 timing, one prefill layer's
#: attention at the longest prompt (Gemma2's at its windowed layers' softcap and window)
SERVE_ATTN = [("phase 6a", "flash[tinyllama]", TL_SERVE_ATTN),
              ("phase 6b", "flash[recurrentgemma]", RG_SERVE_ATTN),
              ("phase 6d", "flash[musicgen-large]", MG_SERVE_ATTN),
              ("phase 6e", "flash[qwen2-vl-2b]", QW_SERVE_ATTN),
              ("phase 6f", "flash[starcoder2-3b]", (1, 512, 24, 2, 128, True, None, None)),
              ("phase 6g", "flash[starcoder2-7b]", (1, 512, 36, 4, 128, True, None, None)),
              ("phase 6h", "flash[gemma2-2b]", (1, 512, 8, 4, 256, True, 4096, 50.0)),
              ("phase 6i", "flash[mixtral-8x7b]", (1, 512, 32, 8, 128, True, 4096, None)),
              ("phase 6j", "flash[dbrx-132b]", (1, 512, 48, 8, 128, True, None, None))]
DECODE_RGLRU = (4, 1, 4096)  # 6b's decode step, one RG-LRU layer
DECODE_WKV = (4, 1, 64, 64)  # 6c's decode step, one RWKV6 layer


def reset_all_counts() -> None:
    from repro_torch.kernels import comm_pack, flash_attention, rglru, rwkv6_wkv

    for mod in (comm_pack, flash_attention, rglru, rwkv6_wkv):
        mod.reset_counts()


def serve_kernel_checks(device):
    """B6 and B7 at T = 1 with a nonzero h0 / s0, B3 at the cells' prefill
    lengths, against their plain versions with phases 1c / 1d / 1b's
    tolerances; then B7's and B3's time in that mode beside its bound (B6's
    is phase 1c's)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6_wkv as wk

    errs = {"rglru": 0.0, "wkv": 0.0, "flash": 0.0}
    # B6: h_t = a h0 + g at T 1 (and T 2 at the same widths, for the threading)
    for T in (1, 2):
        a, g, h0 = rglru_inputs(DECODE_RGLRU[0], T, DECODE_RGLRU[2], device, 60 + T)[:3]
        h, hT = rg.rglru_fwd(a, g, h0)
        want_h, want_hT = rg.rglru_ref(a, g, h0)
        d = max(float((h - want_h).abs().max()), float((hT - want_hT).abs().max()))
        if not d <= 1e-5 or not torch.equal(hT, h[:, -1]):
            fail(f"phase 6: rglru_fwd at ({DECODE_RGLRU[0]}, {T}, {DECODE_RGLRU[2]}) with h0 "
                 f"differs from its plain version: {d:.3e} > 1e-5")
        errs["rglru"] = max(errs["rglru"], d)
    # B7 at T 1 with s0, bf16 r/k/v as the decode step gives them (and f32)
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v, w, u, s0 = wkv_inputs(*DECODE_WKV, device, 71, dtype)[:6]
        out, s = wk.wkv_fwd(r, k, v, w, u, s0)
        want_out, want_s = wk.wkv_ref(r, k, v, w, u, s0)
        for name, got, want in (("out", out, want_out), ("s_final", s, want_s)):
            d = float((got - want).abs().max())
            if not bool(((got - want).abs() <= 2e-4 + 2e-4 * want.abs()).all()):
                fail(f"phase 6: wkv_fwd {name} at {DECODE_WKV} {dtype} with s0 differs from "
                     f"its plain version: max |diff| {d:.3e}")
            errs["wkv"] = max(errs["wkv"], d)
    # B3 at the prefill lengths of the cells with attention (forward and backward kernels,
    # 1b's checks)
    flash_errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    rel: dict = {}
    n = 0
    lens_of = {cell[0]: cell[4] for cell in SERVE_CELLS}
    for tag, _, shape in SERVE_ATTN:
        lens = lens_of[tag]
        for S in sorted(set(lens))[::max(1, len(set(lens)) // 4)] + [max(lens)]:
            check_flash_case((1, S) + shape[2:], torch.bfloat16, device, 80 + S, flash_errs,
                             rel=rel)
            n += 1
    errs["flash"] = flash_errs["fwd"]
    say(f"phase 6: rglru_fwd at T 1 and 2 with h0 (max |diff| {errs['rglru']:.3e}, hT == "
        f"h[:, -1]); wkv_fwd at {DECODE_WKV} with s0, bf16 and f32 r/k/v (max |diff| "
        f"{errs['wkv']:.3e}); flash fwd/dQ/dK-dV at {n} prefill lengths of "
        f"{', '.join(tag.split()[-1] for tag, _, _ in SERVE_ATTN)} (bf16: "
        f"{fmt_rel(rel)}): all within phases 1c / 1d / 1b's tolerances")

    timings = {}  # B6 in this mode is timed in phase 1c
    B, T, H, K = DECODE_WKV
    r, k, v, w, u, s0 = wkv_inputs(B, T, H, K, device, 71, torch.bfloat16)[:6]
    elems = B * T * H * K
    nbytes = (3 * 2 + 4 + 4) * elems + 4 * H * K + 2 * 4 * B * H * K * K  # ..., s0 -> ..., s_final
    timings["wkv"] = kernel_timing(lambda: wk.wkv_fwd(r, k, v, w, u, s0),
                                   lambda: wk.wkv_ref(r, k, v, w, u, s0), None, nbytes,
                                   5 * elems * K, PEAK_FLOPS["tf32"] / 3)
    for _, key, shape in SERVE_ATTN:
        timings[key] = time_serve_flash(shape, device)
    for key, where in [("wkv", f"wkv_fwd {DECODE_WKV} bf16 r/k/v with s0")] + [
            (key, f"{tag}'s flash fwd {shape[:5]}" + (f" window {shape[6]}" if shape[6] else "")
             + (f" softcap {shape[7]:g}" if shape[7] else "") + " bf16")
            for tag, key, shape in SERVE_ATTN]:
        t = timings[key]
        lib = "none" if t["library_ms"] is None else f"{t['library']} {t['library_ms']:.4f} ms"
        say(f"phase 6: {where}, one launch: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {lib}, bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} "
            f"({t['bound_ms'] / t['ms'] * 100:.1f}% of bound)")
    reset_all_counts()
    torch.cuda.empty_cache()
    return errs, timings


def time_serve_flash(shape, device) -> dict:
    """B3's forward in serving mode (a prefill's, no autograd) at one
    layer's ``shape``, timed beside its plain version, the library call
    that computes its function (``attention_yardstick``: SDPA, masked for a
    window; flex attention at a softcap), held within 2e-2 of the kernel's
    output, and its bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    B, S, Hq, Hkv, hd, _, window, softcap = shape
    q, kk, vv, _ = flash_inputs(B, S, S, Hq, Hkv, hd, torch.bfloat16, device, 90)
    opts = dict(window=window, softcap=softcap)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kk, vv))
    lib_name, library = attention_yardstick(qt, kt, vt, window, softcap, device)
    o = fa.flash_attention_fwd(q, kk, vv, **opts)
    out = library().transpose(1, 2)
    if not torch.allclose(out.float(), o.float(), rtol=2e-2, atol=2e-2):
        fail(f"phase 6: the yardstick {lib_name} at {shape[:5]} does not compute the kernel's "
             f"function: max |o diff| {float((out.float() - o.float()).abs().max()):.3e}")
    nbytes, flops = flash_work(B, S, Hq, Hkv, hd, 2, window=window)["fwd"]
    t = kernel_timing(lambda: fa.flash_attention_fwd(q, kk, vv, return_lse=True, **opts),
                      lambda: fa.flash_attention_fwd_ref(q, kk, vv, **opts),
                      library, nbytes, flops, PEAK_FLOPS["bfloat16"])
    return {**t, "library": lib_name}


def kernel_timing(kern, plain, library, nbytes, flops, peak) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"ms": median_ms(kern), "plain_ms": median_ms(plain, reps=3, warmup=1),
            "library_ms": None if library is None else median_ms(library),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def decode_bytes(model, engine) -> int:
    """Bytes one decode step must read: every parameter as stored (the
    embedding table only when tied, as the head; untied, a step gathers a
    row per slot) and the engine's whole cache arena (attention reads every
    slot of the ring, the recurrences their states)."""
    from repro_torch.models.transformer import tree_leaves

    cfg = model.cfg
    params = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                 if n != "embed" or cfg.tie_embeddings)
    cache = sum(t.numel() * t.element_size() for t in tree_leaves(engine._state["caches"]))
    return params + cache


# the port's kernels by the names the device trace gives them (substrings)
TRACE_NAMES = {"flash_fwd": ("flash_fwd_sm90_kernel", "flash_fwd_kernel"),
               "rglru_fwd": ("rglru_fwd_kernel",), "rglru_step": ("rglru_step_kernel",),
               "wkv_fwd_state": ("wkv_fwd_state_kernel",),
               "wkv_fwd_out": ("wkv_fwd_out_kernel",)}


def decode_profile(engine, steps: int = 10, tries: int = 4) -> dict:
    """torch.profiler over ``steps`` decode steps of ``engine`` (every slot
    active, its state saved first and put back after): wall and device-busy
    ms a step, the idle share, device ms a step by kernel class (the classes
    of ``launch.profile_step``), and the launches a step of each of the
    port's kernels, counted by name in the device trace (``TRACE_NAMES``):
    for a graph, what its replays ran.  Two warm-up steps run with the
    tracer already on and are dropped (the first replays under a fresh
    tracer can lose kernel records), and the device is idle at both ends
    of the recorded steps.  Every step launches the same kernels, so a
    trace in which some record's count is not a multiple of ``steps`` lost
    records (one trace of 6b's eager steps kept 259 of 260 B6 step kernels): it
    is taken again from the same state, up to ``tries`` times; the last
    trace is returned either way, for the callers' gates to judge."""
    import torch
    from repro_torch.launch.profile_step import _union_us, kernel_class
    from repro_torch.models.transformer import tree_leaves
    from torch.profiler import ProfilerActivity, profile, schedule

    warm = 2
    saved = [t.clone() for t in tree_leaves(engine._state)]
    for _ in range(tries):
        with torch.inference_mode():
            engine._state["active"].fill_(True)
            engine._launch_step()
            torch.cuda.synchronize()
            once = schedule(wait=0, warmup=warm, active=steps, repeat=1)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=once) as prof:
                for i in range(warm + steps):
                    if i == warm:
                        t0 = time.perf_counter()
                    engine._launch_step()
                    if i in (warm - 1, warm + steps - 1):
                        torch.cuda.synchronize()
                    if i == warm + steps - 1:
                        wall = (time.perf_counter() - t0) * 1e3 / steps
                    prof.step()
            for dst, src in zip(tree_leaves(engine._state), saved):
                dst.copy_(src)
        # the device events, less the schedule's step annotations (each spans its whole step)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        counts: dict = {}
        for e in events:
            counts[e.name] = counts.get(e.name, 0) + 1
        if all(c % steps == 0 for c in counts.values()):
            break
        say(f"decode_profile: a trace of {steps} steps lost records ({len(events)} device "
            f"records); taken again")
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3 / steps
    by_class: dict = {}
    for e in events:
        c = kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    named = {key: sum(any(n in e.name for n in names) for e in events) / steps
             for key, names in TRACE_NAMES.items()}
    names: dict = {}  # every device record a step, by name (phase 8 compares two steps')
    name_ms: dict = {}
    for e in events:
        names[e.name] = names.get(e.name, 0) + 1
        name_ms[e.name] = name_ms.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(name_ms.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1.0 - busy / wall if events else None,
            "kernels": len(events) / steps, "named": named,
            "names": {n: c / steps for n, c in names.items()},
            # the five records that take the most device time a step: short name, launches
            # a step, ms a step
            "top": [(short_name(n), names[n] / steps, round(ms / steps, 4)) for n, ms in top],
            "classes": {c: round(ms / steps, 4)
                        for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1])}}


def serve_counts(cfg) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6_wkv as wk

    return {"flash_fwd": fa.flash_attention_fwd.launches, "rglru_fwd": rg.rglru_fwd.launches,
            "wkv_fwd": wk.wkv_fwd.launches,
            "plain": sum(f.ref_calls for f in (fa.flash_attention_fwd, fa.flash_attention_dq,
                                               fa.flash_attention_dkv, rg.rglru_fwd, rg.rglru_bwd,
                                               wk.wkv_fwd, wk.wkv_bwd)),
            "other": (fa.flash_attention_dq.launches + fa.flash_attention_dkv.launches
                      + rg.rglru_bwd.launches + wk.wkv_bwd.launches)}


def layer_counts(cfg) -> tuple[int, int, int]:
    from repro_torch.models.transformer import ATTN_KINDS

    kinds = cfg.block_kinds()
    return sum(k in ATTN_KINDS for k in kinds), kinds.count("rec"), kinds.count("rwkv")


def check_serve_counts(tag, cfg, res, counts, n_prefills):
    """The wrappers' counters: B3 once per attention layer per prefill and
    never in decode; B6 and B7 once per recurrent layer per prefill and per
    decode step that ran in Python (eager steps, warm-ups, eager probes, the
    capture's warm-up and its recording; a replay runs no wrapper, and
    ``check_step_kernels`` reads what it ran from the device trace); no
    backward kernel, no plain version on the card."""
    attn, rec, rwkv = layer_counts(cfg)
    eng = res.engine
    steps = eng.decode_launches - eng.graph_replays + eng.graph_captures
    want = {"flash_fwd": attn * n_prefills, "rglru_fwd": rec * (n_prefills + steps),
            "wkv_fwd": rwkv * (n_prefills + steps), "plain": 0, "other": 0}
    if counts != want:
        fail(f"{tag}: kernel counts {counts}, want {want} ({attn} attention, {rec} RG-LRU, "
             f"{rwkv} RWKV6 layers; {n_prefills} prefills, {steps} decode steps in Python)")
    return want


def check_step_kernels(tag, cfg, prof):
    """Each profiled decode step ran B6's step kernel once per RG-LRU layer
    and never its tiled one, B7's two kernels once per RWKV6 layer and no
    flash forward, by name in the device trace."""
    _, rec, rwkv = layer_counts(cfg)
    want = {"flash_fwd": 0, "rglru_fwd": 0, "rglru_step": rec, "wkv_fwd_state": rwkv,
            "wkv_fwd_out": rwkv}
    if prof["named"] != want:
        fail(f"{tag}: a decode step's kernels in the device trace {prof['named']}, want {want}")


@contextlib.contextmanager
def prefill_counts():
    """B6's launches inside the serving engine's prefills: the wrapper's
    count read before and after each one (``ServingEngine._prefill_ids``)."""
    from repro_torch.kernels import rglru as rg
    from repro_torch.serving import ServingEngine

    seen = {"prefills": 0, "rglru_fwd": 0}
    prefill = ServingEngine._prefill_ids

    def counted(self, ids):
        before = rg.rglru_fwd.launches
        out = prefill(self, ids)
        seen["prefills"] += 1
        seen["rglru_fwd"] += rg.rglru_fwd.launches - before
        return out

    ServingEngine._prefill_ids = counted
    try:
        yield seen
    finally:
        ServingEngine._prefill_ids = prefill


def prefill_trace(cfg, model, max_seq, prompt, device) -> dict:
    """The port's kernels by name (``TRACE_NAMES``) in the device trace of
    one prefill of ``prompt`` (``make_prefill_step``), after a warm-up
    prefill under the same tracer."""
    import torch
    from repro_torch.launch.steps import make_prefill_step
    from torch.profiler import ProfilerActivity, profile, schedule

    tokens = torch.as_tensor(prompt, dtype=torch.long, device=device)[None]
    prefill = make_prefill_step(cfg, max_seq)
    once = schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=once) as prof:
        for _ in range(2):
            prefill(model, model_inputs(model, tokens))
            torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {key: sum(any(n in name for n in keys) for name in names)
            for key, keys in TRACE_NAMES.items()}


RING_STEPS = 16  # decode steps of the ring check; the JAX ring loses one more key a step
#: The serving cells whose decode steps are held to the full forward, and the parameter dtype
#: held at ``RING_GATE``.  Qwen2-VL's bf16 steps read 1.5e-2 - 2e-2 on an H100: the bf16
#: decode path's own rounding (reduced TinyLlama and StarCoder2 in bf16 read 1e-2 on the CPU, and
#: M-RoPE there reads exactly RoPE's), so its bf16 readings are printed and an f32 copy of the
#: model is held; so is Gemma2-2B's (its softcaps and alternating windows in decode, every
#: prompt inside the 4096 window).  MusicGen's are not held: its decode step adds position 0's sinusoid, as the
#: JAX engine's does (ROADMAP C)
FULL_FORWARD_ARCHS = {"recurrentgemma-9b": "bf16", "qwen2-vl-2b": "f32", "gemma2-2b": "f32"}
RING_GATE = 3e-3  # max |diff| / max|logit| a step of the aligned ring (PERF.md)


def fmt_steps(readings: list[float]) -> str:
    return (f"first {readings[0]:.3e}, step 8 {readings[7]:.3e}, last {readings[-1]:.3e}, "
            f"worst {max(readings):.3e}")


def jax_ring_layout(caches, S: int) -> None:
    """Rewrite, in place, every attention ring shorter than the ``S``-token
    prompt from the port's layout (slot ``p % T`` holds position ``p``) to
    the JAX prefill's (``src/repro/models/layers.py:310-320``: the trailing
    ``T`` positions at slots 0..T-1), which a decode step then misreads."""
    import torch

    with torch.inference_mode():
        for part in caches.values():
            for leaf in part.values():
                if isinstance(leaf, tuple) and leaf[2].shape[-1] < S:
                    k, v, kpos = leaf
                    shift = -(S % kpos.shape[-1])
                    for t, axis in ((k, kpos.dim()), (v, kpos.dim()), (kpos, kpos.dim() - 1)):
                        t.copy_(torch.roll(t, shift, axis))


def window_keys_missing(caches, S: int, q: int) -> int:
    """Over every attention ring shorter than ``S`` (every stage's copy):
    how many of the window's positions ``q - T + 1 .. q`` a decode step at
    position ``q`` finds no key for (the ring holds each at most once)."""
    import torch

    missing = 0
    for part in caches.values():
        for leaf in part.values():
            if isinstance(leaf, tuple) and leaf[2].shape[-1] < S:
                kpos = leaf[2].reshape(-1, leaf[2].shape[-1]).long()
                T = kpos.shape[-1]
                for row in kpos:
                    held = row[(row <= q) & (q - row < T)]
                    missing += min(T, q + 1) - int(torch.unique(held).numel())
    return missing


def model_inputs(model, ids):
    """The forward's input for token ids: the ids, or for an embeds-input arch
    the rows of the model's own table in f32 (the serving engine's stub
    frontend)."""
    if model.cfg.input_mode == "embeds":
        return {"embeds": model.embed[ids].float()}
    return {"tokens": ids}


def ring_check(tag, cfg, model, max_seq, prompt, device, gated=True) -> dict:
    """``prompt``'s prefill (``make_prefill_step``) and ``RING_STEPS``
    greedy decode steps (``make_decode_step``): after each step every
    windowed ring holds a key for each position of its window, and the
    step's logits lie within ``RING_GATE`` x max|logit| of the full forward
    over the prompt and the tokens fed (with ``gated``; else the readings
    are only returned).  Then, where a ring is shorter than
    the prompt, the same steps, fed the same tokens, from the prefill caches
    rewritten to the JAX ring layout: the first step must find window
    positions without a key (the fault the aligned ring repairs); its
    logits' readings are reported beside the aligned ones ("jax" is None
    without such a ring)."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import tree_map

    S = len(prompt)
    tokens = torch.as_tensor(prompt, dtype=torch.long, device=device)[None]
    decode = make_decode_step(cfg)
    with torch.inference_mode():
        # the prefill's caches in the weights' dtype: bf16 as the engine's, f32 for an f32 copy
        logits0, caches = make_prefill_step(cfg, max_seq, cfg.param_dtype)(
            model, model_inputs(model, tokens))
    ringed = any(isinstance(leaf, tuple) and leaf[2].shape[-1] < S  # a ring shorter than S
                 for part in caches.values() for leaf in part.values())
    jax_caches = tree_map(torch.clone, caches) if ringed else None
    fed = [logits0.argmax(-1)]
    aligned, missing = [], 0
    for i in range(RING_STEPS):
        with torch.inference_mode():
            step_in = model_inputs(model, fed[-1][:, None])
        lg, caches = decode(model, caches, step_in,
                            torch.tensor(S + i, dtype=torch.int32, device=device))
        missing += window_keys_missing(caches, S, S + i)
        aligned.append(lg)
        fed.append(lg.argmax(-1))
    del caches
    with torch.inference_mode():
        ids = torch.cat([tokens] + [t[:, None] for t in fed[:RING_STEPS]], 1)
        full = model(**model_inputs(model, ids))[0]
    want = full[0, S:]
    del full

    def readings(steps):
        return [float((lg[0] - want[i]).abs().max() / want[i].abs().max())
                for i, lg in enumerate(steps)]

    out = {"S": S, "aligned": readings(aligned), "jax": None, "jax_missing": None,
           "argmax_equal": bool(aligned[0].argmax() == want[0].argmax())}
    if missing:
        fail(f"{tag}: the aligned ring lacks {missing} window positions over {RING_STEPS} steps")
    if not all(torch.isfinite(lg).all() for lg in aligned) or (
            gated and max(out["aligned"]) > RING_GATE):
        fail(f"{tag}: the {S}-token prompt's decode logits differ from the full forward past "
             f"{RING_GATE:g} x max|logit|: {fmt_steps(out['aligned'])}")
    if not ringed:
        return out
    jax_ring_layout(jax_caches, S)
    jax, jax_missing = [], []
    for i in range(RING_STEPS):
        with torch.inference_mode():
            step_in = model_inputs(model, fed[i][:, None])
        lg, jax_caches = decode(model, jax_caches, step_in,
                                torch.tensor(S + i, dtype=torch.int32, device=device))
        jax_missing.append(window_keys_missing(jax_caches, S, S + i))
        jax.append(lg)
    del jax_caches
    out["jax"], out["jax_missing"] = readings(jax), jax_missing
    if not jax_missing[0]:
        fail(f"{tag}: the JAX prefill's ring holds every window position at the first decode: "
             f"the check cannot tell the misaligned ring")
    return out


def reckon_serve_bytes(cfg, slots: int, max_seq: int) -> int:
    """Static bytes of a serving run, reckoned before it on ``meta``
    tensors: each parameter once in its dtype (``reckon_bytes`` without
    gradients, optimizer state or wire) and the engine's f32 cache arena."""
    import torch
    from repro_torch.models import Transformer, init_caches
    from repro_torch.models.transformer import tree_leaves

    weights = sum(p.numel() * p.element_size()
                  for p in Transformer(cfg, device="meta", seed=None).parameters())
    arena = init_caches(cfg, slots, max_seq, dtype=torch.float32, device="meta")
    return weights + sum(t.numel() * t.element_size() for t in tree_leaves(arena))


def serve_depth(arch, slots, max_seq) -> tuple[int, str]:
    """The depth a serving cell runs at, and why: every layer, or for
    ``SERVE_CUT_ARCHS`` the deepest whose reckoned static bytes stay within
    ``SERVE_STATIC_BUDGET``."""
    from repro_torch.configs import get_config

    full = get_config(arch).n_layers
    if arch not in SERVE_CUT_ARCHS:
        return full, f"all {full}"
    one, two = (reckon_serve_bytes(get_config(arch, n_layers=n), slots, max_seq) for n in (1, 2))
    per_layer = two - one
    depth = min(full, int((SERVE_STATIC_BUDGET - (one - per_layer)) // per_layer))
    why = (f"{depth} of {full} (the deepest within {SERVE_STATIC_BUDGET / 1e9:.0f} GB of weights "
           f"and arena: {per_layer / 1e9:.3f} GB a layer, {(one - per_layer) / 1e9:.3f} GB "
           f"besides; {reckon_serve_bytes(get_config(arch, n_layers=depth), slots, max_seq) / 1e9:.2f} "
           f"GB reckoned; all {full} would take "
           f"{reckon_serve_bytes(get_config(arch), slots, max_seq) / 1e9:.1f} GB)")
    return depth, why


def serve_cell(tag, arch, slots, max_seq, lens, tokens, device):
    """One serving cell through ``launch.serve.run``, at full depth or the
    depth ``serve_depth`` reckons: the CUDA graph engine, then the eager one
    on the same weights and requests."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    from repro_torch.serving import Request, ServingEngine

    t0 = time.perf_counter()
    depth, why = serve_depth(arch, slots, max_seq)
    cfg = get_config(arch, n_layers=depth)
    model = Transformer(cfg, device=device, seed=0)
    args = ["--arch", arch, "--slots", str(slots), "--requests", str(len(lens)),
            "--prompt-lens", ",".join(map(str, lens)), "--tokens", str(tokens),
            "--max-seq", str(max_seq), "--fabric", "gpu_nccl", "--device", str(device)]
    _, rec, _ = layer_counts(cfg)
    out = {}
    for mode, graph in (("graph", True), ("eager", False)):
        reset_all_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with prefill_counts() as pre:
            res = serve.run(args, model=model, cuda_graph=graph, quiet=True)
        torch.cuda.synchronize()
        counts = serve_counts(cfg)
        check_serve_counts(f"{tag} {mode}", cfg, res, counts, len(lens))
        if pre != {"prefills": len(lens), "rglru_fwd": rec * len(lens)}:
            fail(f"{tag} {mode}: B6 launches inside the prefills {pre}, want {rec} a prefill "
                 f"over {len(lens)} prefills")
        toks = {r.rid: r.generated for r in res.completed}
        if len(toks) != len(lens) or any(len(t) != tokens for t in toks.values()):
            fail(f"{tag} {mode}: {len(toks)} requests completed, lengths "
                 f"{sorted({len(t) for t in toks.values()})}")
        stats = res.engine.compile_stats()
        if graph and (stats["graph_captures"] != 1 or res.engine.graph_captures != 1):
            fail(f"{tag}: {stats['graph_captures']} decode graphs captured, want 1 (none after a "
                 f"join or a retirement)")
        out[mode] = {"res": res, "counts": counts, "prefill_counts": pre, "tokens": toks,
                     "stats": stats,
                     "steps": res.engine.decode_launches, "replays": res.engine.graph_replays,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "prefill_ms": statistics.median(res.timer.prefill_times) * 1e3,
                     "step_ms": res.engine.observed_step_time() * 1e3}
    g, e = out["graph"], out["eager"]
    if g["tokens"] != e["tokens"]:
        bad = [rid for rid in g["tokens"] if g["tokens"][rid] != e["tokens"][rid]]
        fail(f"{tag}: the captured step's tokens differ from the eager step's for requests {bad}")
    vocab_ok = all(0 <= t < cfg.vocab for ts in g["tokens"].values() for t in ts)
    if not vocab_ok:
        fail(f"{tag}: a token outside the vocabulary")

    # batched == solo: the two equal-length requests, together and alone (same slots)
    reqs = serve.make_requests(serve.parse_args(args), cfg.vocab)[:2]

    def serve_solo(rs):
        eng = ServingEngine(cfg, model, slots=slots, max_seq=max_seq, cuda_graph=True)
        for r in rs:
            eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=SERVE_SOLO_TOKENS))
        done = {r.rid: r.generated for r in eng.run_to_completion()}
        if eng.graph_captures != 1:
            fail(f"{tag}: {eng.graph_captures} graphs captured by one engine")
        del eng
        return done

    both = serve_solo(reqs)
    for r in reqs:
        alone = serve_solo([r])
        if alone[r.rid] != both[r.rid]:
            fail(f"{tag}: request {r.rid} batched {both[r.rid]} != alone {alone[r.rid]}")

    # the decode-step profile, captured (for what its replays run) and, at the cells of
    # SERVE_EAGER_PROFILE, eager
    prof = {"graph": decode_profile(g["res"].engine, steps=10 if arch != "rwkv6-7b" else 3)}
    if tag in SERVE_EAGER_PROFILE:
        prof["eager"] = decode_profile(e["res"].engine)
    for mode, p in prof.items():
        check_step_kernels(f"{tag} {mode}", cfg, p)
    # a prefill runs B6's tiled kernel once per RG-LRU layer and never the step kernel
    pre_trace = None
    if rec:
        req = serve.make_requests(serve.parse_args(args), cfg.vocab)[-1]
        pre_trace = prefill_trace(cfg, model, max_seq, req.prompt, device)
        if (pre_trace["rglru_fwd"], pre_trace["rglru_step"]) != (rec, 0):
            fail(f"{tag}: the {len(req.prompt)}-token prefill's device trace holds B6's tiled "
                 f"kernel {pre_trace['rglru_fwd']} times and its step kernel "
                 f"{pre_trace['rglru_step']} times, want {rec} and 0")

    # the longest prompt's decode steps against the full forward, with the ring as the port
    # writes it and as the JAX prefill writes it
    fwd = fwd32 = None
    if arch in FULL_FORWARD_ARCHS:
        req = serve.make_requests(serve.parse_args(args), cfg.vocab)[-1]
        f32 = FULL_FORWARD_ARCHS[arch] == "f32"
        fwd = ring_check(tag, cfg, model, max_seq, req.prompt, device, gated=not f32)
        if f32:
            import dataclasses

            cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
            model32 = Transformer(cfg32, device=device, seed=None)
            model32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
            fwd32 = ring_check(f"{tag} f32", cfg32, model32, max_seq, req.prompt, device)
            del model32
            torch.cuda.empty_cache()
    # a tied table kept in f32 is cast to the bf16 head inside every decode step; that cast
    # alone, by device time (it shares its kernel's name with the step's other casts)
    head_cast = None
    if cfg.tie_embeddings and model.embed.dtype != cfg.param_dtype:
        with torch.inference_mode():
            ms = device_ms(lambda: model.embed.T.to(cfg.param_dtype))
        moved = model.embed.numel() * (model.embed.element_size() + 2)
        head_cast = {"ms": ms, "gb": moved / 1e9, "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
    plan = g["res"].plan
    bound_ms = decode_bytes(model, g["res"].engine) / HBM_BYTES_PER_S * 1e3
    res = {
        "counts": {m: out[m]["counts"] for m in out}, "prefill_ms": g["prefill_ms"],
        "step_ms": g["step_ms"], "eager_step_ms": e["step_ms"],
        "tok_s": g["res"].n_tokens / g["res"].seconds,
        "eager_tok_s": e["res"].n_tokens / e["res"].seconds,
        "peak_gb": max(g["peak_gb"], e["peak_gb"]),
        "predicted_ms": plan.predicted_step_time() * 1e3, "bound_ms": bound_ms, "fwd": fwd,
        "fwd32": fwd32,
        "prof": prof, "steps": g["steps"], "replays": g["replays"],
        "prefill_launches": g["prefill_counts"]["rglru_fwd"], "head_cast": head_cast,
    }
    say(f"{tag}: {arch} {why} layers bf16, {slots} slots / max_seq {max_seq}, "
        f"{len(lens)} requests (prompts {min(lens)}-{max(lens)}) x {tokens} tokens, greedy: "
        f"captured step tokens == eager step tokens for every request; batched == alone for "
        f"the two {lens[0]}-token requests; 1 decode graph, none after joins or retirements; "
        f"kernel counts {out['graph']['counts']} (graph run) and {out['eager']['counts']} "
        f"(eager run), {res['steps']} decode steps in the graph run")
    say(f"{tag}: prefill {res['prefill_ms']:.2f} ms a request (median); decode step "
        f"{res['step_ms']:.3f} ms captured, {res['eager_step_ms']:.3f} ms eager; "
        f"{res['tok_s']:.1f} tokens/s captured ({res['eager_tok_s']:.1f} eager); peak "
        f"{res['peak_gb']:.2f} GB; plan predicted step {res['predicted_ms']:.3f} ms (calibrated) "
        f"against {res['step_ms']:.3f} ms observed; bound {bound_ms:.3f} ms "
        f"({decode_bytes(model, g['res'].engine) / 1e9:.2f} GB of weights and caches at 3.35 "
        f"TB/s, {bound_ms / res['step_ms'] * 100:.1f}% of it)")
    if pre_trace:
        say(f"{tag}: B6 launches inside the prefills (the wrapper's count around each): "
            f"{g['prefill_counts']['rglru_fwd']} over {g['prefill_counts']['prefills']} prefills "
            f"(graph run); the {max(lens)}-token prefill's device trace, by name: {pre_trace}")
    for mode, p in prof.items():
        idle = "not measured" if p["idle"] is None else f"{p['idle']:.3f}"
        named = {k: int(v) for k, v in p["named"].items()}
        say(f"{tag}: {mode} decode step under torch.profiler: {p['wall_ms']:.3f} ms wall, "
            f"{p['busy_ms']:.3f} ms device busy, idle share {idle}, {p['kernels']:.0f} kernels "
            f"a step, of them by name {named}; device ms a step by class {p['classes']}; the "
            f"records taking the most (name, launches a step, ms a step): {p['top']}")
    if fwd32:
        say(f"{tag}: the {fwd['S']}-token request's {RING_STEPS} decode steps against the full "
            f"forward at positions {fwd['S']}-{fwd['S'] + RING_STEPS - 1}, max |diff| / "
            f"max|logit| a step: the f32 copy of the weights {fmt_steps(fwd32['aligned'])} (gate "
            f"{RING_GATE:g}; first argmax equal {fwd32['argmax_equal']}); the bf16 model "
            f"{fmt_steps(fwd['aligned'])} (printed, not gated: bf16 rounding)")
    elif fwd:
        say(f"{tag}: the {fwd['S']}-token request's {RING_STEPS} decode steps against the full "
            f"forward at positions {fwd['S']}-{fwd['S'] + RING_STEPS - 1}, max |diff| / "
            f"max|logit| a step: aligned ring {fmt_steps(fwd['aligned'])} (gate {RING_GATE:g}; "
            f"first argmax equal {fwd['argmax_equal']}; every window position held); the JAX "
            f"prefill's ring {fmt_steps(fwd['jax'])}, window positions without a key over its "
            f"rings at steps 1 / 8 / {RING_STEPS}: {fwd['jax_missing'][0]} / "
            f"{fwd['jax_missing'][7]} / {fwd['jax_missing'][-1]}")
    if head_cast:
        say(f"{tag}: the tied f32 table's cast to the bf16 head, alone, as each decode step runs "
            f"it: {head_cast['ms']:.4f} ms device time ({head_cast['gb']:.2f} GB moved, bound "
            f"{head_cast['bound_ms']:.3f} ms), of the captured step's "
            f"{prof['graph']['busy_ms']:.3f} ms device busy")
    say(f"{tag}: {time.perf_counter() - t0:.1f} s")
    del model, g, e, out
    torch.cuda.empty_cache()
    return res


def serve_reduced(device):
    """The ten archs' reduced configs through the engine in f32, on the card
    (CUDA graph) and on the CPU (eager): the same greedy tokens over
    ``SERVE_REDUCED_STEPS`` steps, and the first request's prefill logits
    within 1e-4 x max|logit|.  Reduced StarCoder2's and Qwen2-VL's head dim
    24 is raised to 32 on both sides (``kernel_head_dim``)."""
    import numpy as np
    import torch
    from repro_torch.configs import PORTED_ARCHS, get_reduced
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Transformer
    from repro_torch.serving import Request, ServingEngine, gumbel_sampler

    worst = 0.0
    for arch in PORTED_ARCHS:
        cfg = kernel_head_dim(get_reduced(arch, param_dtype=torch.float32))
        cpu = Transformer(cfg, device="cpu", seed=0)
        gpu = Transformer(cfg, device=device, seed=None)
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32) for n in (12, 20, 33)]
        done = []
        for model in (gpu, cpu):
            eng = ServingEngine(cfg, model, slots=2, max_seq=64)
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p, max_new_tokens=SERVE_REDUCED_STEPS))
            done.append({r.rid: r.generated for r in eng.run_to_completion()})
        if done[0] != done[1]:
            fail(f"phase 6: reduced {arch} through the engine: card {done[0]} != CPU {done[1]}")
        with torch.inference_mode():
            first = [make_prefill_step(cfg, 64)(m, model_inputs(m, torch.as_tensor(
                prompts[0][None], dtype=torch.long, device=m.embed.device)))[0].cpu()
                for m in (gpu, cpu)]
        d, top = float((first[0] - first[1]).abs().max()), float(first[1].abs().max())
        if not d <= 1e-4 * top:
            fail(f"phase 6: reduced {arch} prefill logits on the card differ from the CPU: "
                 f"{d:.3e} > 1e-4 x {top:.3e}")
        worst = max(worst, d / top)
        if arch == "tinyllama-1.1b":  # seeded sampling inside the graph repeats on its seed
            drawn = []
            for seed in (2, 2, 3):
                eng = ServingEngine(cfg, gpu, slots=2, max_seq=64, sample=gumbel_sampler(1.0),
                                    sample_seed=seed)
                for rid, p in enumerate(prompts):
                    eng.submit(Request(rid=rid, prompt=p, max_new_tokens=SERVE_REDUCED_STEPS))
                drawn.append({r.rid: r.generated for r in eng.run_to_completion()})
            if drawn[0] != drawn[1]:
                fail(f"phase 6: seeded sampling in the CUDA graph does not repeat on its seed: "
                     f"{drawn[0]} != {drawn[1]}")
            sampled_differs = drawn[0] != drawn[2]
    say(f"phase 6: seeded sampling (Gumbel-max, T 1) inside the CUDA graph: seed 2 twice gives "
        f"the same tokens; seed 3 gives {'others' if sampled_differs else 'the same'}")
    say(f"phase 6: the {len(PORTED_ARCHS)} archs' reduced configs through the engine in "
        f"f32, card (CUDA graph) against CPU (eager): greedy tokens equal over "
        f"{SERVE_REDUCED_STEPS} steps for 3 requests each; first logits within "
        f"{worst:.3e} x max|logit| (gate 1e-4)")
    reset_all_counts()


def phase_serve(device):
    """Phase 6: the kernels in serving mode, the five full-depth cells, the
    reduced archs card against CPU."""
    t0 = time.perf_counter()
    errs, timings = serve_kernel_checks(device)
    cells = {tag: serve_cell(tag, arch, slots, max_seq, lens, tokens, device)
             for tag, arch, slots, max_seq, lens, tokens in SERVE_CELLS}
    serve_reduced(device)
    say(f"phase 6: {time.perf_counter() - t0:.1f} s")
    return errs, timings, cells


# ---------------------------------------------------------------------------
# Phase 7: resilient serving and the fleet at full width
# ---------------------------------------------------------------------------

SNAP_ROOT = ROOT / "build" / "chip_smoke_snapshots"  # every cell's own directory, removed
P7_LENS = SERVE_CELLS[0][4]  # 6a's prompt lengths, 64-512 tokens
P7_TOKENS = 64
P7_SNAPSHOT_REPS = 3
P7B_LENS = serve_lens(4, 256, 2304, exact=2304)
P7B_TOKENS = 32
FLEET_ARGS = ["--arch", "tinyllama-1.1b", "--replicas", "3", "--slots", "4", "--max-seq", "1024",
              "--requests", "24", "--prompt-len", "128", "--tokens", "32", "--rate", "1e6",
              "--load-seed", "0", "--snapshot-every", "32", "--fabric", "gpu_nccl"]
FLEET_CHAOS = ["--chaos-kill-at", "4", "--chaos-replicas", "0", "--max-restores", "0"]


class StepClock:
    """A clock that advances ``dt`` seconds a call: deadlines, heartbeats
    and arrivals then depend on the calls made, not on the host's speed."""

    def __init__(self, dt: float = 1e-3):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


@contextlib.contextmanager
def snapshot_seconds():
    """The serve loops' snapshot writes (``ServeLoopDriver.snapshot_now``
    through ``resilience.save_snapshot``): each one's host seconds, in
    order."""
    from repro_torch.serving import resilience

    seen: list[float] = []
    save = resilience.save_snapshot

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = save(*args, **kwargs)
        seen.append(time.perf_counter() - t0)
        return out

    resilience.save_snapshot = timed
    try:
        yield seen
    finally:
        resilience.save_snapshot = save


def snapshot_dir(tag: str) -> pathlib.Path:
    path = SNAP_ROOT / tag.replace(" ", "_")
    shutil.rmtree(path, ignore_errors=True)
    return path


def resilient_cell(tag, model, cfg, args, chaos, restarts, min_fallbacks=0):
    """``launch.serve.run`` of ``args`` under ``chaos``, with the launcher's
    uninterrupted run beside it: every request's tokens equal that run's,
    ``restarts`` restarts and at least ``min_fallbacks`` fallbacks, one graph
    captured by the chaos engine across its restores, and the wrappers'
    counts those of the prefills (both engines' own counts) and of the
    decode steps run in Python, with no plain call and no backward kernel."""
    import torch
    from repro_torch.launch import serve

    reset_all_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with prefill_counts() as pre:
        res = serve.run(args, model=model, chaos=chaos, quiet=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = serve_counts(cfg)
    rep, eng, ref = res.report, res.engine, res.reference
    if res.tokens_match is not True:
        got = {r.rid: r.generated for r in res.completed}
        want = {r.rid: r.generated for r in ref.completed}
        bad = sorted(rid for rid in want if got.get(rid) != want[rid])
        fail(f"{tag}: the killed and restored run's tokens differ from the uninterrupted run's "
             f"for requests {bad}")
    if rep.restarts != restarts or rep.snapshot_fallbacks < min_fallbacks:
        fail(f"{tag}: {rep.restarts} restarts and {rep.snapshot_fallbacks} snapshot fallbacks, "
             f"want {restarts} and at least {min_fallbacks}")
    if eng.graph_captures != 1 or eng.compile_stats()["graph_captures"] != 1:
        fail(f"{tag}: the chaos engine captured {eng.graph_captures} graphs across "
             f"{rep.restarts} restores, want 1")
    attn, rec, rwkv = layer_counts(cfg)
    prefills = eng.prefills + ref.prefills
    steps = sum(e.decode_launches - e.graph_replays + e.graph_captures for e in (eng, ref))
    want = {"flash_fwd": attn * prefills, "rglru_fwd": rec * (prefills + steps),
            "wkv_fwd": rwkv * (prefills + steps), "plain": 0, "other": 0}
    if counts != want or pre != {"prefills": prefills, "rglru_fwd": rec * prefills}:
        fail(f"{tag}: kernel counts {counts} (inside the prefills {pre}), want {want} "
             f"({prefills} prefills counted by the engines, {steps} decode steps in Python)")
    if len(res.completed) != len(ref.completed) or any(not 0 <= t < cfg.vocab for r in
                                                       res.completed for t in r.generated):
        fail(f"{tag}: {len(res.completed)} requests completed, or a token outside the vocabulary")
    return {"res": res, "counts": counts, "prefills": prefills, "chaos_prefills": eng.prefills,
            "steps_in_python": steps, "prefill_launches": pre["rglru_fwd"], "seconds": seconds,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def snapshot_timing(engine, directory) -> dict:
    """Each part of a snapshot and its restore on ``engine``, median of
    ``P7_SNAPSHOT_REPS``: the copy to the host, the write (CRC-32s and the
    atomic rename included), the load with its CRC-32 checks, and the copy
    into the captured graph's buffers; every state tensor keeps its storage
    and no graph is captured."""
    import torch
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.serving import load_snapshot, snapshot_engine, write_snapshot

    ptrs = [t.data_ptr() for t in tree_leaves(engine._state)]
    parts = {"host_ms": [], "write_ms": [], "load_ms": [], "restore_ms": []}
    for i in range(P7_SNAPSHOT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = snapshot_engine(engine, step=1000 + i)
        t1 = time.perf_counter()
        write_snapshot(snap, str(directory))
        t2 = time.perf_counter()
        loaded = load_snapshot(str(directory), 1000 + i, engine)
        t3 = time.perf_counter()
        engine.restore_snapshot(loaded)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key].append(dt * 1e3)
        shutil.rmtree(directory / f"step_{1000 + i:08d}")
    if [t.data_ptr() for t in tree_leaves(engine._state)] != ptrs or engine.graph_captures != 1:
        fail("phase 7a: a restore rebound a state tensor or captured a graph")
    return {"bytes": snap.nbytes, **{k: statistics.median(v) for k, v in parts.items()}}


def fmt_recovery(rep, backoff=0.05) -> str:
    """The loop's recovery seconds, and each less its backoff sleep."""
    rec = rep.recovery_times_s
    net = [r - backoff * 2 ** i for i, r in enumerate(rec)]
    return (f"recovery {', '.join(f'{r:.3f}' for r in rec)} s (less the backoff "
            f"{', '.join(f'{r:.3f}' for r in net)} s)")


def phase_resilient_tinyllama(device) -> dict:
    """7a: TinyLlama-1.1B through ``launch.serve.run`` with snapshots every
    8 steps, a kill every 12 (3 at most), the snapshot of step 24 corrupted
    and a partial write after step 36; then the snapshot's parts timed; then
    a seeded ``gumbel_sampler(1.0)`` run of 4 requests killed at steps 5 and
    17."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.serving import ChaosConfig

    cfg = get_config("tinyllama-1.1b")
    model = Transformer(cfg, device=device, seed=0)
    d = snapshot_dir("phase 7a")
    args = ["--arch", "tinyllama-1.1b", "--slots", "8", "--max-seq", "1024", "--requests",
            str(len(P7_LENS)), "--prompt-lens", ",".join(map(str, P7_LENS)), "--tokens",
            str(P7_TOKENS), "--fabric", "gpu_nccl", "--device", str(device),
            "--snapshot-every", "8", "--snapshot-dir", str(d)]
    greedy = resilient_cell("phase 7a", model, cfg, args, ChaosConfig(
        kill_every=12, max_kills=3, corrupt_snapshot_at=24, partial_write_at=36), restarts=3,
        min_fallbacks=1)
    rep = greedy["res"].report
    timing = snapshot_timing(greedy["res"].engine, d)
    shutil.rmtree(d, ignore_errors=True)
    say(f"phase 7a: tinyllama-1.1b all 22 layers bf16, 8 slots / max_seq 1024, "
        f"{len(P7_LENS)} requests (prompts {min(P7_LENS)}-{max(P7_LENS)}) x {P7_TOKENS} tokens, "
        f"greedy, snapshots every 8 steps, killed every 12 (3 kills), the snapshot of step 24 "
        f"corrupted, a partial write after step 36: tokens == the uninterrupted run's for every "
        f"request; {rep.steps} steps, {rep.restarts} restarts, {rep.snapshots} snapshots, "
        f"{rep.snapshot_fallbacks} fallback(s); 1 graph captured across the restores; "
        f"flash fwd {greedy['counts']['flash_fwd']} = 22 x {greedy['prefills']} prefills "
        f"({greedy['chaos_prefills']} the chaos engine's), no plain call; "
        f"{fmt_recovery(rep)}; {greedy['seconds']:.1f} s with the uninterrupted run, peak "
        f"{greedy['peak_gb']:.2f} GB")
    say(f"phase 7a: a snapshot of {timing['bytes'] / 1e9:.4f} GB (cache arena, positions, "
        f"mask, budgets, both generators), median of {P7_SNAPSHOT_REPS}: to the host "
        f"{timing['host_ms']:.1f} ms, written with CRC-32s {timing['write_ms']:.1f} ms, loaded "
        f"and verified {timing['load_ms']:.1f} ms, restored into the graph's buffers "
        f"{timing['restore_ms']:.1f} ms")

    d = snapshot_dir("phase 7a gumbel")
    sampled_args = args[:]
    sampled_args[sampled_args.index("--requests") + 1] = "4"
    sampled_args[sampled_args.index("--snapshot-dir") + 1] = str(d)
    sampled = resilient_cell("phase 7a gumbel", model, cfg, sampled_args + [
        "--temperature", "1.0"], ChaosConfig(kill_at=(5, 17)), restarts=2)
    shutil.rmtree(d, ignore_errors=True)
    srep = sampled["res"].report
    say(f"phase 7a: gumbel_sampler(1.0), seed 2, 4 requests x {P7_TOKENS} tokens, killed at "
        f"steps 5 and 17: tokens == the uninterrupted seeded run's for every request (both "
        f"generators restored, the step's registered with the graph); {srep.steps} steps, "
        f"{srep.restarts} restarts, 1 graph captured; {fmt_recovery(srep)}")
    for cell in (greedy, sampled):
        del cell["res"]
    out = {"greedy": greedy, "timing": timing, "sampled": sampled}
    del model
    torch.cuda.empty_cache()
    return out


def phase_resilient_recurrentgemma(device) -> dict:
    """7b: RecurrentGemma-9B, all 38 layers, as 6b: 4 requests of 256-2304
    prompt tokens x 32, snapshots every 4 steps, killed at steps 9 and 21;
    then B6 by name in the device trace of the replays and of a prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.serving import ChaosConfig

    cfg = get_config("recurrentgemma-9b")
    model = Transformer(cfg, device=device, seed=0)
    d = snapshot_dir("phase 7b")
    args = ["--arch", "recurrentgemma-9b", "--slots", "4", "--max-seq", "4096", "--requests",
            str(len(P7B_LENS)), "--prompt-lens", ",".join(map(str, P7B_LENS)), "--tokens",
            str(P7B_TOKENS), "--fabric", "gpu_nccl", "--device", str(device),
            "--snapshot-every", "4", "--snapshot-dir", str(d)]
    cell = resilient_cell("phase 7b", model, cfg, args, ChaosConfig(kill_at=(9, 21)),
                          restarts=2)
    shutil.rmtree(d, ignore_errors=True)
    res = cell["res"]
    prof = decode_profile(res.engine, steps=3)
    check_step_kernels("phase 7b", cfg, prof)
    _, rec, _ = layer_counts(cfg)
    first = make_requests_p7b(cfg)[0].prompt
    pre_trace = prefill_trace(cfg, model, 4096, first, device)
    if (pre_trace["rglru_fwd"], pre_trace["rglru_step"]) != (rec, 0):
        fail(f"phase 7b: a prefill's device trace holds B6's tiled kernel "
             f"{pre_trace['rglru_fwd']} times and its step kernel {pre_trace['rglru_step']} "
             f"times, want {rec} and 0")
    rep = res.report
    snap_gb = res.engine.snapshot().nbytes / 1e9
    say(f"phase 7b: recurrentgemma-9b all 38 layers bf16, 4 slots / max_seq 4096, "
        f"{len(P7B_LENS)} requests (prompts {min(P7B_LENS)}-{max(P7B_LENS)}) x {P7B_TOKENS} "
        f"tokens, greedy, snapshots of {snap_gb:.4f} GB every 4 steps, killed at steps 9 and "
        f"21: tokens == the uninterrupted run's for every request (the (conv, h) states, the "
        f"rings and kpos restored); {rep.steps} steps, {rep.restarts} restarts, 1 graph; kernel "
        f"counts {cell['counts']} over {cell['prefills']} prefills (B6 inside them "
        f"{cell['prefill_launches']}) and {cell['steps_in_python']} decode steps in Python; by "
        f"name a replay runs {int(prof['named']['rglru_step'])} B6 step kernels and no tiled "
        f"one, a {len(first)}-token prefill "
        f"{pre_trace['rglru_fwd']} tiled and no step kernel; {fmt_recovery(rep)}; "
        f"{cell['seconds']:.1f} s with the uninterrupted run, peak {cell['peak_gb']:.2f} GB")
    cell["graph_replays"] = res.engine.graph_replays
    del cell["res"], model, res  # the 38-layer model goes with its engines
    out = {"cell": cell, "prof": prof}
    torch.cuda.empty_cache()
    return out


def make_requests_p7b(cfg):
    from repro_torch.launch import serve

    return serve.make_requests(serve.parse_args([
        "--arch", "recurrentgemma-9b", "--requests", str(len(P7B_LENS)), "--prompt-lens",
        ",".join(map(str, P7B_LENS)), "--tokens", str(P7B_TOKENS)]), cfg.vocab)


def fleet_run(tag, model, args, clock):
    """One ``launch.serve_fleet.run``; the wrappers' counts around it held
    to the prefills its replicas counted (B3 once per attention layer in
    each, fresh or resumed), no plain call, one graph per replica."""
    import torch
    from repro_torch.launch import serve_fleet

    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serve_fleet.run(args, model=model, clock=clock, quiet=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = serve_counts(model.cfg)
    engines = [r.engine for r in res.fleet.replicas]
    prefills = sum(e.prefills for e in engines)
    want = {"flash_fwd": layer_counts(model.cfg)[0] * prefills, "rglru_fwd": 0, "wkv_fwd": 0, "plain": 0, "other": 0}
    if counts != want:
        fail(f"{tag}: kernel counts {counts}, want {want} ({prefills} prefills over the replicas)")
    if [e.graph_captures for e in engines] != [1] * len(engines):
        fail(f"{tag}: graphs captured per replica {[e.graph_captures for e in engines]}, want 1")
    return res, counts, prefills, seconds


def phase_fleet(device) -> dict:
    """7c: 3 TinyLlama-1.1B replicas sharing one model on the card, through
    ``launch.serve_fleet.run``: 24 requests of 128 prompt tokens x 32 at
    1e6 requests/s from seed 0; replica 0 killed at its step 4 with no
    restore budget, on a step clock, twice (the same tokens per request);
    then a fault-free run on the wall clock."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    cfg = get_config("tinyllama-1.1b")
    model = Transformer(cfg, device=device, seed=0)
    runs = []
    for i in range(2):
        d = snapshot_dir(f"phase 7c {i}")
        res, counts, prefills, seconds = fleet_run(
            "phase 7c", model, FLEET_ARGS + FLEET_CHAOS + [
                "--device", str(device), "--snapshot-root", str(d)], StepClock())
        shutil.rmtree(d, ignore_errors=True)
        s = res.report.summary()
        if (s["replica_deaths"], s["completed"], s["failover_token_mismatches"],
                s["goodput_tokens"]) != (1, 24, 0, 24 * 32) or s["failovers"] < 1:
            fail(f"phase 7c: {s}")
        moved = [r for r in res.report.completed.values() if r.retries]
        if not moved or any(r.replica_id == 0 or len(r.generated) != 32 for r in moved):
            fail(f"phase 7c: failed-over requests {[(r.rid, r.replica_id) for r in moved]}")
        runs.append({"tokens": {rid: r.generated for rid, r in res.report.completed.items()},
                     "summary": s, "counts": counts, "prefills": prefills, "seconds": seconds,
                     "moved": len(moved)})
        del res
    if runs[0]["tokens"] != runs[1]["tokens"]:
        bad = [rid for rid in runs[0]["tokens"] if runs[0]["tokens"][rid] != runs[1]["tokens"][rid]]
        fail(f"phase 7c: a second identical run gives other tokens for requests {bad}")
    d = snapshot_dir("phase 7c wall")
    with snapshot_seconds() as snaps:
        res, counts, prefills, seconds = fleet_run(
            "phase 7c wall", model,
            FLEET_ARGS + ["--device", str(device), "--snapshot-root", str(d)], None)
    shutil.rmtree(d, ignore_errors=True)
    wall = res.report.summary()
    if wall["completed"] != 24:
        fail(f"phase 7c: the fault-free run completed {wall['completed']} of 24")
    r0 = runs[0]
    say(f"phase 7c: 3 tinyllama-1.1b replicas (one model, 4 slots / max_seq 1024 and one graph "
        f"each), 24 requests of 128 prompt tokens x 32 at 1e6 requests/s, replica 0 killed at "
        f"its step 4 with no restore budget, on a step clock: deaths {r0['summary']['replica_deaths']}, "
        f"failovers {r0['summary']['failovers']} ({r0['moved']} requests moved), completed "
        f"{r0['summary']['completed']}, token mismatches 0, goodput {r0['summary']['goodput_tokens']} "
        f"tokens; a second run gives the same tokens for every request; flash fwd "
        f"{r0['counts']['flash_fwd']} = 22 x {r0['prefills']} prefills (fresh and resumed), no "
        f"plain call; {r0['seconds']:.1f} s a run")
    say(f"phase 7c: fault-free on the wall clock: p50 {wall['p50_latency_s'] * 1e3:.1f} ms, p99 "
        f"{wall['p99_latency_s'] * 1e3:.1f} ms, goodput {wall['goodput_tok_per_s']:.1f} tok/s "
        f"({wall['goodput_tokens']} tokens in {wall['wall_s']:.3f} s, {wall['rounds']} rounds, "
        f"of them {sum(snaps[3:]):.3f} s in {len(snaps) - 3} snapshot writes; the 3 taken as "
        f"the replicas were built, before the run, {sum(snaps[:3]):.3f} s); flash fwd "
        f"{counts['flash_fwd']} = 22 x {prefills} prefills")
    out = {"runs": runs, "wall": wall, "wall_counts": counts, "wall_snapshots": snaps}
    del model
    torch.cuda.empty_cache()
    return out


def phase_resilience(device) -> dict:
    """Phase 7: 7a, 7b and 7c; the snapshots' directory removed at the end."""
    t0 = time.perf_counter()
    try:
        out = {"7a": phase_resilient_tinyllama(device),
               "7b": phase_resilient_recurrentgemma(device),
               "7c": phase_fleet(device)}
    finally:
        shutil.rmtree(SNAP_ROOT, ignore_errors=True)
    reset_all_counts()
    say(f"phase 7: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 8: sharded serving on a one-rank NCCL group
# ---------------------------------------------------------------------------

P8_STORE = ROOT / "build" / "chip_smoke_pg"  # the NCCL world's FileStore, removed at the end
P8_AXES = {"model": 8}  # 8a prices its plans at the TP deployment it would run
P8B_LAYERS = 8  # Mixtral-8x7B at full width: 8 of 32 layers (23.7 GB bf16; 32 need 93 GB)
P8B_LENS = serve_lens(8, 64, 512)
P8B_TOKENS = 32
#: Mixtral's attention in 8b's longest prefill, one layer: (1, S, 32/8, hd 128), window 4096
MX_SERVE_ATTN = (1, max(P8B_LENS), 32, 8, 128, True, 4096, None)
P8C_TOKENS = 32


def short_name(name: str) -> str:
    """A device record's name without its return type, namespaces, template
    arguments and parameters: ``indexSelectSmallIndex``, ``Memcpy DtoD``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut].rsplit("::", 1)[-1].strip()


def wire_records(sharded: dict, unsharded: dict) -> dict:
    """What the sharded step adds to a step's device trace: each record
    (by ``short_name``) whose count a step differs from the unsharded
    step's, with the difference (the wire's kernels and copies, whatever
    NCCL names them)."""
    diff: dict = {}
    for names, sign in ((sharded["names"], 1), (unsharded["names"], -1)):
        for n, c in names.items():
            diff[short_name(n)] = diff.get(short_name(n), 0) + sign * c
    return {n: round(d, 2) for n, d in sorted(diff.items()) if round(d, 2)}


@contextlib.contextmanager
def nccl_world():
    """A one-rank NCCL world on a FileStore under ``build/`` and its
    ``("model",)`` mesh, torn down after."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    shutil.rmtree(P8_STORE, ignore_errors=True)
    P8_STORE.mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(P8_STORE / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield make_mesh((1,), ("model",), device_type="cuda")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(P8_STORE, ignore_errors=True)


def serve_requests(arch, lens, tokens, vocab):
    """The launcher's requests for these prompt lengths (seed 0)."""
    from repro_torch.launch import serve

    args = serve.parse_args(["--arch", arch, "--requests", str(len(lens)),
                             "--prompt-lens", ",".join(map(str, lens)), "--tokens", str(tokens)])
    return serve.make_requests(args, vocab)


def sharded_run(cfg, model, slots, max_seq, reqs, plan, mesh, graph) -> dict:
    """One engine (sharded with ``mesh``, else unsharded) over ``reqs``: the
    tokens, the ``issue()`` calls of its warm-up (with a graph: the capture's
    warm-up run and its recording) and of its run, the kernel counts, the
    decode step's median ms and the engine."""
    import torch
    from repro_torch.fabric.ops import issue
    from repro_torch.serving import Request, ServeTimer, ServingEngine

    timer = ServeTimer()
    eng = ServingEngine(cfg, model, slots=slots, max_seq=max_seq, plan=plan, mesh=mesh,
                        timer=timer, cuda_graph=graph)
    reset_all_counts()
    issue.calls = 0
    eng.warmup()
    warm = issue.calls
    for r in reqs:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {"engine": eng, "tokens": {r.rid: r.generated for r in done}, "warm_calls": warm,
            "run_calls": issue.calls - warm, "counts": serve_counts(cfg),
            "step_ms": timer.median() * 1e3, "tok_s": sum(len(r.generated) for r in done) / secs}


def check_sharded(tag, cfg, run, base, groups, n_prefills, graph) -> None:
    """The gates of a sharded run: the unsharded run's tokens; with a graph
    one capture, the plan's groups through ``issue()`` in the capture's
    warm-up and again in its recording, none from the replays; eager, the
    groups every step; B3 = attention layers x prefills and no other
    kernel or plain call."""
    eng = run["engine"]
    if run["tokens"] != base["tokens"]:
        bad = [rid for rid in base["tokens"] if run["tokens"].get(rid) != base["tokens"][rid]]
        fail(f"{tag}: sharded tokens differ from the unsharded engine's for requests {bad}")
    if graph:
        calls = (run["warm_calls"], run["run_calls"], eng.graph_captures)
        if calls != (2 * groups, 0, 1):
            fail(f"{tag}: issue() calls (warm-up + recording, replays) and captures {calls}, "
                 f"want ({2 * groups}, 0, 1)")
    else:
        want = (groups, groups * (eng.decode_launches - 1))
        if (run["warm_calls"], run["run_calls"]) != want:
            fail(f"{tag}: eager issue() calls (warm-up, run) "
                 f"{(run['warm_calls'], run['run_calls'])}, want {want}")
    attn, _, _ = layer_counts(cfg)
    want = {"flash_fwd": attn * n_prefills, "rglru_fwd": 0, "wkv_fwd": 0, "plain": 0, "other": 0}
    if run["counts"] != want:
        fail(f"{tag}: kernel counts {run['counts']}, want {want}")


def phase_sharded_tinyllama(device, mesh) -> dict:
    """8a: TinyLlama-1.1B x 22 under ``mg_wfbp`` and ``wfbp`` serve plans
    (``gpu_nccl`` at ``{"model": 8}``), executed on the one-rank group,
    captured and eager, against the unsharded engine on the same model."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fabric.ops import issue
    from repro_torch.models import Transformer, param_shapes
    from repro_torch.planning import build_serve_plan

    t0 = time.perf_counter()
    _, arch, slots, max_seq, lens, tokens = SERVE_CELLS[0]  # 6a's
    cfg = get_config(arch)
    model = Transformer(cfg, device=device, seed=0)
    reqs = serve_requests(arch, lens, tokens, cfg.vocab)
    plans = {pol: build_serve_plan(cfg, param_shapes(cfg), "gpu_nccl", P8_AXES, batch_rows=slots,
                                   policy=pol, cache_dtype_bytes=4, act_dtype_bytes=4)
             for pol in ("mg_wfbp", "wfbp")}
    base = sharded_run(cfg, model, slots, max_seq, reqs, plans["mg_wfbp"], None, True)
    b3 = base["counts"]["flash_fwd"]
    runs = {}
    for pol, graph in (("mg_wfbp", True), ("mg_wfbp", False), ("wfbp", True)):
        run = sharded_run(cfg, model, slots, max_seq, reqs, plans[pol], mesh, graph)
        check_sharded(f"phase 8a {pol} {'captured' if graph else 'eager'}", cfg, run, base,
                      len(plans[pol].schedule.groups), len(reqs), graph)
        b3 += run["counts"]["flash_fwd"]
        runs[(pol, graph)] = run
    prof = {key: decode_profile(runs[key]["engine"]) for key in (("mg_wfbp", True),
                                                                 ("wfbp", True))}
    prof["unsharded"] = decode_profile(base["engine"])
    for key, p in prof.items():
        check_step_kernels(f"phase 8a {key}", cfg, p)
    # the variadic wire's coalesced all-reduce on the same NCCL group
    a = torch.arange(7, dtype=torch.float32, device=device)
    b = torch.ones(5, dtype=torch.float32, device=device)
    before = issue.calls
    issue("all_reduce", [a, b], mesh.get_group("model"))
    torch.cuda.synchronize()
    if issue.calls - before != 1 or not (torch.equal(a.cpu(), torch.arange(7.0))
                                         and bool((b == 1).all())):
        fail("phase 8a: the coalesced all-reduce on the one-rank NCCL group is not one issue() "
             "leaving its tensors as they were")
    say(f"phase 8a: {arch} x {cfg.n_layers} bf16, {slots} slots / max_seq {max_seq}, "
        f"{len(reqs)} requests (6a's prompts) x {tokens} tokens, greedy, on a one-rank NCCL "
        f"group: plans priced at {P8_AXES} on gpu_nccl, mg_wfbp {len(plans['mg_wfbp'].schedule.groups)} "
        f"group(s), wfbp {len(plans['wfbp'].schedule.groups)}; sharded tokens (captured and "
        f"eager) == the unsharded engine's for every request; one capture per engine; issue() "
        f"= groups in the capture's warm-up and again in its recording, none in the replays, "
        f"groups every eager step; B3 = 22 x 16 prefills a run, none in a replay (device trace), "
        f"no plain call; the coalesced all-reduce one issue()")
    say(f"phase 8a: decode step ms (median, captured): unsharded {base['step_ms']:.3f}, sharded "
        f"mg_wfbp {runs[('mg_wfbp', True)]['step_ms']:.3f}, sharded wfbp "
        f"{runs[('wfbp', True)]['step_ms']:.3f}; sharded mg_wfbp eager "
        f"{runs[('mg_wfbp', False)]['step_ms']:.3f}; tokens/s unsharded {base['tok_s']:.1f}, "
        f"mg_wfbp {runs[('mg_wfbp', True)]['tok_s']:.1f}, wfbp {runs[('wfbp', True)]['tok_s']:.1f}")
    for key, p in prof.items():
        name = key if isinstance(key, str) else f"sharded {key[0]}"
        added = "" if isinstance(key, str) else (
            f"; records a step beyond the unsharded step's, by name: "
            f"{wire_records(p, prof['unsharded'])}")
        say(f"phase 8a: {name} captured step under torch.profiler: {p['wall_ms']:.3f} ms wall, "
            f"{p['busy_ms']:.3f} ms device busy, {p['kernels']:.0f} device records a step"
            f"{added}; device ms by class {p['classes']}")
    out = {"b3": b3, "base_tokens": base["tokens"], "model": model, "cfg": cfg, "reqs": reqs,
           "plans": plans, "step_ms": {"unsharded": base["step_ms"],
                                       **{f"{k[0]}|{k[1]}": r["step_ms"] for k, r in runs.items()}}}
    del base, runs
    say(f"phase 8a: {time.perf_counter() - t0:.1f} s")
    return out


def phase_sharded_mixtral(device, mesh) -> dict:
    """8b: Mixtral-8x7B at full width, 8 of 32 layers, under a ``wfbp`` /
    ``tpu_v5e`` serve plan (its groups all-to-alls), captured, against the
    unsharded engine on the same model."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, param_shapes
    from repro_torch.planning import build_serve_plan

    t0 = time.perf_counter()
    arch, slots, max_seq = "mixtral-8x7b", 4, 1024
    cfg = get_config(arch, n_layers=P8B_LAYERS)
    model = Transformer(cfg, device=device, seed=0)
    reqs = serve_requests(arch, P8B_LENS, P8B_TOKENS, cfg.vocab)
    plan = build_serve_plan(cfg, param_shapes(cfg), "tpu_v5e", P8_AXES, batch_rows=slots,
                            policy="wfbp", cache_dtype_bytes=4, act_dtype_bytes=4)
    if plan.op != "all_to_all":
        fail(f"phase 8b: Mixtral's serve plan issues {plan.op}, want all_to_all")
    base = sharded_run(cfg, model, slots, max_seq, reqs, plan, None, True)
    run = sharded_run(cfg, model, slots, max_seq, reqs, plan, mesh, True)
    groups = len(plan.schedule.groups)
    check_sharded("phase 8b", cfg, run, base, groups, len(reqs), True)
    prof = decode_profile(run["engine"], steps=5)
    base_prof = decode_profile(base["engine"], steps=5)
    for p in (prof, base_prof):
        check_step_kernels("phase 8b", cfg, p)
    params = sum(p.numel() for p in model.parameters())
    say(f"phase 8b: {arch} x {cfg.n_layers} of 32 at full width ({params / 1e9:.2f} B params "
        f"bf16), {slots} slots / max_seq {max_seq}, {len(reqs)} requests (prompts "
        f"{min(P8B_LENS)}-{max(P8B_LENS)}) x {P8B_TOKENS}, wfbp on tpu_v5e at {P8_AXES}: "
        f"{groups} all_to_all groups; sharded captured tokens == unsharded for every request; "
        f"one capture; issue() = {groups} in the capture's warm-up and again in its recording, "
        f"none in the replays; B3 = {cfg.n_layers} x {len(reqs)} prefills, no plain call")
    say(f"phase 8b: decode step ms (median, captured): unsharded {base['step_ms']:.3f}, sharded "
        f"{run['step_ms']:.3f}; under torch.profiler sharded {prof['wall_ms']:.3f} ms wall, "
        f"{prof['busy_ms']:.3f} device busy ({prof['kernels']:.0f} records), unsharded "
        f"{base_prof['wall_ms']:.3f} / {base_prof['busy_ms']:.3f} ({base_prof['kernels']:.0f}); "
        f"records a step beyond the unsharded step's, by name: "
        f"{wire_records(prof, base_prof)}; device ms by class (sharded) {prof['classes']}")
    b3 = base["counts"]["flash_fwd"] + run["counts"]["flash_fwd"]
    del base, run, model
    torch.cuda.empty_cache()
    say(f"phase 8b: {time.perf_counter() - t0:.1f} s")
    return {"b3": b3}


def phase_sharded_launcher(device, p8a) -> dict:
    """8c: ``launch.serve.run(... --sharded --measure-comm)`` on the group
    (TP clamped to 1), then one ``install_plan`` to the ``wfbp`` plan on its
    engine: a second capture, the same tokens."""
    import contextlib as ctx
    import io

    from repro_torch.fabric.ops import issue
    from repro_torch.launch import serve
    from repro_torch.serving import Request

    t0 = time.perf_counter()
    _, arch, slots, max_seq, lens, _ = SERVE_CELLS[0]
    cfg, model = p8a["cfg"], p8a["model"]
    args = ["--arch", arch, "--slots", str(slots), "--requests", str(len(lens)),
            "--prompt-lens", ",".join(map(str, lens)), "--tokens", str(P8C_TOKENS),
            "--max-seq", str(max_seq), "--fabric", "gpu_nccl", "--device", str(device)]
    # the unsharded launcher first, then a second round of the same requests on its engine:
    # the engine's shared kpos row carries over (ROADMAP C), so the sharded engine's second
    # round after install_plan is held to this engine's second round
    reset_all_counts()
    plain = serve.run(args, model=model, quiet=True)
    plain_eng = plain.engine
    for r in p8a["reqs"]:
        plain_eng.submit(Request(rid=1000 + r.rid, prompt=r.prompt, max_new_tokens=P8C_TOKENS))
    plain_eng.run_to_completion()
    want = {r.rid: r.generated for r in plain.completed if r.rid < 1000}
    want2 = {r.rid - 1000: r.generated for r in plain_eng.completed if r.rid >= 1000}
    del plain, plain_eng
    buf = io.StringIO()
    with ctx.redirect_stdout(buf):
        res = serve.run(args + ["--sharded", "--measure-comm"], model=model)
    out = buf.getvalue()
    got = {r.rid: r.generated for r in res.completed}
    groups = len(res.plan.schedule.groups)
    for line in ("only 1 devices visible; clamping TP 8 -> 1", "sharded TP=1",
                 "measured fit all_gather@model: a=", "measured-fabric plan:",
                 "per-group predicted vs measured:"):
        if line not in out:
            fail(f"phase 8c: the launcher printed no '{line}' line:\n{out}")
    if out.count(" meas=") != groups or got != want or res.engine.graph_captures != 1:
        fail(f"phase 8c: {out.count(' meas=')} measured groups of {groups}, tokens equal "
             f"{got == want}, {res.engine.graph_captures} captures")
    eng = res.engine
    wfbp = p8a["plans"]["wfbp"]
    eng.install_plan(wfbp)
    issue.calls = 0
    for r in p8a["reqs"]:
        eng.submit(Request(rid=1000 + r.rid, prompt=r.prompt, max_new_tokens=P8C_TOKENS))
    eng.run_to_completion()
    again = {r.rid - 1000: r.generated for r in eng.completed if r.rid >= 1000}
    b3 = serve_counts(cfg)["flash_fwd"]
    if again != want2 or eng.graph_captures != 2 \
            or issue.calls != 2 * len(wfbp.schedule.groups):
        fail(f"phase 8c: after install_plan(wfbp): tokens equal {again == want2}, "
             f"{eng.graph_captures} captures (want 2), {issue.calls} issue() calls (want "
             f"{2 * len(wfbp.schedule.groups)}: the new capture's warm-up and recording)")
    fit = [ln for ln in out.splitlines() if "measured fit" in ln][0]
    table = [ln.strip() for ln in out.splitlines() if " meas=" in ln or "step: fixed" in ln]
    mplan = [ln for ln in out.splitlines() if "measured-fabric plan" in ln][0]
    say(f"phase 8c: launch.serve.run --sharded --measure-comm at TP 1 (clamped from 8): "
        f"{fit.split('[serve] ')[-1]}; {mplan.split('[serve] ')[-1]}; per group: {table}")
    say(f"phase 8c: {len(got)} requests x {P8C_TOKENS} tokens equal the unsharded launcher's; "
        f"install_plan(wfbp, {len(wfbp.schedule.groups)} groups) captured once more (2 "
        f"captures), {issue.calls} issue() calls (warm-up + recording); a second round of the "
        f"requests equals the unsharded engine's second round")
    say(f"phase 8c: {time.perf_counter() - t0:.1f} s")
    return {"b3": b3}


def phase_sharded(device):
    """Phase 8: 8a, 8b, 8c on one NCCL world of one card; B3 at 8a's and
    8b's prefill shapes against its plain version and timed."""
    import torch

    t0 = time.perf_counter()
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    rel: dict = {}
    for S in sorted(set(P8B_LENS)):
        check_flash_case((1, S) + MX_SERVE_ATTN[2:], torch.bfloat16, device, 80 + S, errs, rel=rel)
    timing = {"tinyllama": time_serve_flash(TL_SERVE_ATTN, device),
              "mixtral": time_serve_flash(MX_SERVE_ATTN, device)}
    say(f"phase 8: flash fwd/dQ/dK-dV at Mixtral's serve shape {MX_SERVE_ATTN[2:7]} at 8b's "
        f"{len(set(P8B_LENS))} prefill lengths (bf16: {fmt_rel(rel)}): within phase 1b's "
        f"tolerances")
    for key, shape in (("tinyllama", TL_SERVE_ATTN), ("mixtral", MX_SERVE_ATTN)):
        t = timing[key]
        say(f"phase 8: {key}'s flash fwd {shape[:5]}" + (f" window {shape[6]}" if shape[6] else "")
            + f" bf16, one launch: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} "
            f"({t['bound_ms'] / t['ms'] * 100:.1f}% of bound)")
    reset_all_counts()
    with nccl_world() as mesh:
        p8a = phase_sharded_tinyllama(device, mesh)
        p8c = phase_sharded_launcher(device, p8a)
        del p8a["model"]
        torch.cuda.empty_cache()
        p8b = phase_sharded_mixtral(device, mesh)
    reset_all_counts()
    say(f"phase 8: {time.perf_counter() - t0:.1f} s")
    return {"errs": errs, "timing": timing, "b3_tinyllama": p8a["b3"] + p8c["b3"],
            "b3_mixtral": p8b["b3"], "step_ms": p8a["step_ms"]}


# ---------------------------------------------------------------------------
# Phase 9: the what-if simulator on the card's measured costs, the examples
# ---------------------------------------------------------------------------

P9_HOSTS = (8, 64, 512)
P9_FABRICS = ("paper_10gbe", "gpu_nccl")
P9_POLICIES = ("synceasgd", "wfbp", "mg_wfbp", "dp_optimal")
#: two partitions of equal cost may sum their floats in other orders: a t_iter
#: within this share of another's is a tie
P9_TIE = 1e-12
P9_OUT = ROOT / "build" / "phase9_whatif.json"
P9_CLI_OUT = ROOT / "build" / "phase9_cli.json"
P9_EXAMPLES = ROOT / "build" / "phase9_examples"  # the examples' checkpoints and snapshots


def measured_sim_costs(p4):
    """Phase 4's startup probe as a cost vector: each unit's backward seconds
    as the card gave them and its forward as the probe's remaining share
    (``(1 - BWD_FRACTION) / BWD_FRACTION`` of it: the probes time forward +
    backward), over the bytes of ``lm_unit_costs`` at phase 4's tokens a
    device (the f32 wire)."""
    from repro_torch.core.trainer import lm_unit_costs
    from repro_torch.models import param_shapes
    from repro_torch.planning import MeasuredCosts
    from repro_torch.runtime import BWD_FRACTION

    cfg = p4["cfg"]
    base = lm_unit_costs(cfg, param_shapes(cfg), p4["tokens"])
    secs = p4["profile"].unit_seconds
    if sorted(secs) != sorted(c.name for c in base):
        fail(f"phase 9: the probe's units {sorted(secs)} are not lm_unit_costs' "
             f"{[c.name for c in base]}")
    bwd = [secs[c.name] for c in base]
    fwd = [b * (1.0 - BWD_FRACTION) / BWD_FRACTION for b in bwd]
    return MeasuredCosts.from_unit_times(base, bwd, fwd, name="h100_probe").layer_costs()


def sim_exactness(p4, costs) -> float:
    """9a: the DES on phase 4's plan, costs and fit against ``evaluate``, bit
    for bit."""
    from repro_torch.core.timeline import evaluate
    from repro_torch.planning import MEASURED_HW
    from repro_torch.sim import simulate_train_iteration

    groups, fit = p4["plan"].schedule.groups, p4["fit"]
    sim = simulate_train_iteration(groups, costs, fit, hw=MEASURED_HW, multipliers=(1.0,))
    ref = evaluate(list(groups), costs, fit, hw=MEASURED_HW)
    if sim.t_iter != ref.t_iter or sim.groups != tuple(ref.groups):
        bad = [i for i, (a, b) in enumerate(zip(sim.groups, ref.groups)) if a != b]
        fail(f"phase 9a: the DES gives t_iter {sim.t_iter!r} against evaluate's {ref.t_iter!r}; "
             f"groups {bad} differ")
    pred, obs = p4["predicted"], p4["observed"]
    say(f"phase 9a: the DES on phase 4's measured costs (24 units from its probe), its fit "
        f"(α = {fit.a:.4e} s, β = {fit.b:.4e} s/B) and its adopted {len(groups)}-group plan "
        f"equals core.timeline.evaluate bit for bit: t_iter and every group's start and end; "
        f"simulated t_iter {sim.t_iter * 1e3:.3f} ms (compute {(sim.t_f + sim.t_b) * 1e3:.3f} ms "
        f"from the probe) beside phase 4's tuner predicted {pred * 1e3:.3f} ms (probe backward, "
        f"analytic forward) and observed "
        + (f"{obs * 1e3:.3f} ms" if obs else "none"))
    return sim.t_iter


def sim_whatif(costs, p4, card) -> dict:
    """9b: the paper's what-if on the measured costs: every policy at 8 / 64
    / 512 hosts on two fabric presets, a straggler row and an elastic row."""
    from repro_torch.planning import MEASURED_HW, build_schedule
    from repro_torch.sim import ClusterEvent, ClusterSpec, SimReport, replay_train, \
        row_from_replay

    arch = p4["cfg"].name

    def build() -> SimReport:
        rows = []
        for fabric in P9_FABRICS:
            for n in P9_HOSTS:
                cluster = ClusterSpec(n_hosts=n, fabric=fabric)
                for policy in P9_POLICIES:
                    res = replay_train(cluster, list(costs), policy, hw=MEASURED_HW)
                    rows.append(row_from_replay(res, arch, fabric, n))
        return SimReport(rows=tuple(rows), provenance={
            "arch": arch, "costs": "chip_smoke.py phase 4 probe, measured on the card",
            "card": card, "source": "chip_smoke.py phase 9"})

    report, again = build(), build()
    if report.to_json() != again.to_json():
        fail("phase 9b: two builds of the what-if SimReport differ")
    report.save(P9_OUT)
    gaps = {}
    for fabric in P9_FABRICS:
        for n in P9_HOSTS:
            t = {r.policy: r.t_iter_s for r in report.select(fabric=fabric, n_hosts=n)}
            mg = t["mg_wfbp"]
            for other in ("wfbp", "synceasgd"):
                if mg > t[other] * (1 + P9_TIE):
                    fail(f"phase 9b: {fabric} x {n}: mg_wfbp's t_iter {mg!r} > {other}'s "
                         f"{t[other]!r}")
            if t["dp_optimal"] > mg * (1 + P9_TIE):
                fail(f"phase 9b: {fabric} x {n}: dp_optimal's t_iter {t['dp_optimal']!r} > "
                     f"mg_wfbp's {mg!r}")
            gaps[(fabric, n)] = (mg - t["dp_optimal"]) / mg
    say(f"phase 9b: simulated from the H100-measured unit costs of phase 4 ({card}) and the "
        f"fabric presets, not measured on 8, 64 or 512 hosts; the report (two builds "
        f"byte-identical) in {P9_OUT.relative_to(ROOT)}:")
    for line in report.efficiency_table():
        say(f"phase 9b:   {line}")
    say("phase 9b: mg_wfbp <= wfbp and <= synceasgd, dp_optimal <= mg_wfbp in every cell; "
        "dp_optimal below mg_wfbp by: " + ", ".join(
            f"{f} x {n} {g * 100:.3f}%" for (f, n), g in gaps.items()))
    merge = {}
    for fabric in P9_FABRICS:
        for n in P9_HOSTS:
            ar = ClusterSpec(n_hosts=n, fabric=fabric).ar_model()
            merge[(fabric, n)] = build_schedule("mg_wfbp", list(costs), ar, hw=MEASURED_HW).groups
    world1 = build_schedule("mg_wfbp", list(costs), p4["fit"], hw=MEASURED_HW).groups
    say(f"phase 9b: mg_wfbp's merge set on the measured world-1 fit: {len(world1)} groups "
        f"{list(world1)}; at paper_10gbe x 64: {len(merge[('paper_10gbe', 64)])} groups "
        f"{list(merge[('paper_10gbe', 64)])}; groups by cell: "
        + ", ".join(f"{f} x {n} {len(g)}" for (f, n), g in merge.items()))

    strag = []
    for spread in (0.0, 0.2, 0.5):
        cluster = ClusterSpec(n_hosts=64, fabric="paper_10gbe", straggler_spread=spread, seed=3)
        strag.append(replay_train(cluster, list(costs), "mg_wfbp", hw=MEASURED_HW).mean_t_iter)
    if not strag[0] <= strag[1] <= strag[2]:
        fail(f"phase 9b: t_iter not monotone in the straggler spread: {strag}")
    elastic = ClusterSpec(n_hosts=64, fabric="paper_10gbe", events=(
        ClusterEvent(at_iter=2, kind="shrink", count=32),
        ClusterEvent(at_iter=4, kind="grow", count=32),
        ClusterEvent(at_iter=6, kind="kill", count=8)))
    el = replay_train(elastic, list(costs), "mg_wfbp", hw=MEASURED_HW, n_iters=8)
    alive = [it["n_alive"] for it in el.iterations]
    if (el.n_replans, el.n_kills) != (3, 8) or alive != [64, 64, 32, 32, 64, 64, 56, 56]:
        fail(f"phase 9b: elastic replay: {el.n_replans} re-plans, {el.n_kills} kills, "
             f"alive {alive}")
    say(f"phase 9b: stragglers at paper_10gbe x 64 (seed 3), mg_wfbp t_iter at spread 0.0 / "
        f"0.2 / 0.5: " + " / ".join(f"{t * 1e3:.3f}" for t in strag) + " ms, monotone; "
        f"elastic 64 -> 32 -> 64, then 8 killed: {el.n_replans} re-plans, {el.n_kills} kills, "
        f"alive {'/'.join(map(str, alive))}, groups "
        f"{[it['n_groups'] for it in el.iterations]}, t_iter ms "
        f"{[round(it['t_iter_s'] * 1e3, 3) for it in el.iterations]}")
    return {"report": report, "gaps": gaps, "merge": merge, "world1": world1}


def sim_serve(cell6a) -> dict:
    """9c: 6a's workload replayed at 6a's captured decode step."""
    from repro_torch.serving import LoadSpec
    from repro_torch.sim import replay_serve

    tag, arch, slots, _, lens, tokens = SERVE_CELLS[0]
    step_s = cell6a["step_ms"] / 1e3
    load = LoadSpec(n_requests=len(lens), prompt_len=1, max_new_tokens=tokens, kind="trace",
                    trace_arrivals_s=(0.0,) * len(lens), seed=0)
    one = replay_serve(load, step_s, n_replicas=1, slots=slots)
    if (one.completed, one.lost, one.tokens_emitted) != (len(lens), 0, len(lens) * tokens):
        fail(f"phase 9c: one replica: {one.to_json_dict()}")
    kill = (tokens / 2 + 0.5) * step_s  # mid-step, half way through a run on two replicas
    two = replay_serve(load, step_s, n_replicas=2, slots=slots, kill_at_s={0: kill})
    if two.failovers < 1 or two.lost or two.completed != len(lens):
        fail(f"phase 9c: two replicas, replica 0 killed at {kill} s: {two.to_json_dict()}")
    say(f"phase 9c: {tag}'s {len(lens)} requests x {tokens} tokens, {slots} slots, at its "
        f"captured decode step {cell6a['step_ms']:.3f} ms: one replica {one.completed} "
        f"completed, {one.lost} lost, {one.tokens_emitted} tokens, {one.steps} steps, simulated "
        f"decode {one.tokens_per_s:.1f} tokens/s (prefill and admission unpriced) beside 6a's "
        f"observed {cell6a['tok_s']:.1f} tokens/s (prefills included); two replicas, replica 0 "
        f"killed at {kill * 1e3:.1f} ms: {two.completed} completed, {two.failovers} failovers, "
        f"{two.lost} lost, {two.tokens_per_s:.1f} tokens/s, p99 {two.latency_percentile(99):.3f} s")
    return {"one": one, "two": two}


def load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv: list[str]):
    """``examples/<name>.py``'s ``main(argv)`` in this process, its printout
    kept and shown only if it raises; (result, seconds, printout)."""
    import io

    mod = load_example(name)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv)
    except BaseException:
        print(buf.getvalue(), flush=True)
        raise
    return out, time.perf_counter() - t0, buf.getvalue()


def sim_cli_and_examples(device) -> dict:
    """9d: the simulate CLI in a subprocess, then the training, serving and
    elastic examples on the card."""
    import os

    from repro_torch.kernels import comm_pack, launch_counts
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.sim import SimReport

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.simulate", "--arch", "googlenet",
         "--sweep-hosts", "8,64", "--calibrate", "--report-out", str(P9_CLI_OUT)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    cli_s = time.perf_counter() - t0
    cal = [ln for ln in out.stdout.splitlines() if ln.startswith("[simulate] calibration/")]
    if out.returncode != 0 or len(cal) != 2 or not all("ok=True" in ln for ln in cal):
        fail(f"phase 9d: the simulate CLI: rc {out.returncode}, calibration lines {cal}; "
             f"{out.stderr[-2000:]}")
    rep = SimReport.load(P9_CLI_OUT)
    if not (rep.calibration["train"]["ok"] and rep.calibration["serve"]["ok"]) \
            or {r.n_hosts for r in rep.rows} != {8, 64}:
        fail(f"phase 9d: the CLI's report {P9_CLI_OUT}: {rep.calibration}, {len(rep.rows)} rows")
    say(f"phase 9d: python -m repro_torch.launch.simulate --arch googlenet --sweep-hosts 8,64 "
        f"--calibrate: exit 0 in {cli_s:.1f} s, " + "; ".join(ln[11:] for ln in cal)
        + f"; {len(rep.rows)} rows read back from {P9_CLI_OUT.relative_to(ROOT)}")

    shutil.rmtree(P9_EXAMPLES, ignore_errors=True)
    P9_EXAMPLES.mkdir(parents=True)
    reset_all_counts()
    train, train_s, printed = run_example("torch_train_lm", [
        "--tiny", "--steps", "40", "--device", str(device),
        "--ckpt-dir", str(P9_EXAMPLES / "train")])
    plain = {fn.__name__: fn.ref_calls for fn in (
        comm_pack.pack_arena, comm_pack.unpack_arena, fa.flash_attention_fwd,
        fa.flash_attention_dq, fa.flash_attention_dkv)}
    totals = launch_counts()
    first, final, groups = train["first_loss"], train["final_loss"], train["groups"]
    if not (final < 0.7 * first) or len(train["step_launches"]) != 40:
        fail(f"phase 9d: torch_train_lm --tiny: loss {first} -> {final} over "
             f"{len(train['step_launches'])} steps (must fall below 0.7x its start)")
    layers = 4  # reduced TinyLlama
    per = {"pack_arena": groups, "unpack_arena": groups, "flash_attention_fwd": 2 * layers,
           "flash_attention_dq": layers, "flash_attention_dkv": layers}
    for i, got in enumerate(train["step_launches"]):
        if got != per:
            fail(f"phase 9d: torch_train_lm step {i}: launches {got}, want {per}")
    if any(plain.values()):
        fail(f"phase 9d: torch_train_lm: plain calls {plain}")
    say(f"phase 9d: examples/torch_train_lm.py --tiny --steps 40 --device cuda: "
        f"{train_s:.1f} s, {printed.strip().splitlines()[-1]}; "
        f"every step pack = unpack = {groups} (its plan's groups), flash fwd / dQ / dK-dV "
        f"{2 * layers} / {layers} / {layers} at the reduced shape (not a row of the kernels "
        f"table; over the run: {totals['flash_attention_fwd']} / {totals['flash_attention_dq']} "
        f"/ {totals['flash_attention_dkv']}), 0 plain calls")
    res = {"pack_launches": totals["pack_arena"], "unpack_launches": totals["unpack_arena"],
           "cli_s": cli_s, "train_s": train_s}

    reset_all_counts()
    serve, res["serve_s"], printed = run_example("torch_serve_decode", ["--device", str(device)])
    if not serve["match"] or serve["tp"] != 1:
        fail(f"phase 9d: torch_serve_decode: sharded tokens equal unsharded: {serve['match']} "
             f"(TP {serve['tp']})")
    served = {k: v for k, v in launch_counts().items() if v}
    say(f"phase 9d: examples/torch_serve_decode.py --device cuda: {res['serve_s']:.1f} s, "
        f"sharded (TP 1) tokens == unsharded for all {len(serve['sharded'])} requests; "
        f"launches {served}; "
        + "; ".join(ln.strip() for ln in printed.splitlines() if ln.startswith("observed step")))

    reset_all_counts()
    elastic, res["elastic_s"], _ = run_example("torch_elastic_restart", [
        "--device", str(device), "--ckpt-dir", str(P9_EXAMPLES / "elastic_ckpt"),
        "--snapshot-dir", str(P9_EXAMPLES / "elastic_snap")])
    if elastic["restarts"] != 1 or elastic["resumed"] != elastic["expected"]:
        fail(f"phase 9d: torch_elastic_restart: {elastic['restarts']} restarts, resumed tokens "
             f"equal: {elastic['resumed'] == elastic['expected']}")
    say(f"phase 9d: examples/torch_elastic_restart.py --device cuda: {res['elastic_s']:.1f} s, "
        f"1 restart (failure at step 25, restored from step 20), resumed under the N=64 "
        f"schedule from step {elastic['resumed_step']}, the serving snapshot's resumed tokens "
        f"== the unbroken run's for all {len(elastic['resumed'])} requests")
    reset_all_counts()
    return res


def phase_sim(device, p4, cell6a, card) -> dict:
    """Phase 9: 9a-9d (see the module docstring)."""
    t0 = time.perf_counter()
    costs = measured_sim_costs(p4)
    t_iter = sim_exactness(p4, costs)
    whatif = sim_whatif(costs, p4, card)
    serve = sim_serve(cell6a)
    say(f"phase 9a-9c: {time.perf_counter() - t0:.1f} s of host time")
    try:
        examples = sim_cli_and_examples(device)
    finally:
        shutil.rmtree(P9_EXAMPLES, ignore_errors=True)
    say(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return {"t_iter": t_iter, "whatif": whatif, "serve": serve, **examples}


# ---------------------------------------------------------------------------
# Phase 10: the dry run (fake 256 / 512-rank worlds) and one rank's segment
# ---------------------------------------------------------------------------


def start_dryrun_cells() -> list:
    """Phase 10a's CLI runs, started together, each in its own process
    (``--fabric gpu_nccl``, a record under ``build/phase10``), output to a
    log file beside it."""
    import os

    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    cells = []
    for arch, shape, extra in (("tinyllama-1.1b", "train_4k", ("reduced",)),) + DRYRUN_CELLS:
        key = arch + (f"__{extra[extra.index('--remat') + 1]}" if "--remat" in extra else "")
        if extra == ("reduced",):
            key, extra, head = DRYRUN_REDUCED_KEY, (), ["-c", DRYRUN_REDUCED]
        else:
            head = ["-m", "repro_torch.launch.dryrun"]
        tag = f"{key}__{shape}"
        out, log = DRYRUN_OUT / f"{tag}.json", DRYRUN_OUT / f"{tag}.log"
        out.unlink(missing_ok=True)
        with open(log, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, *head, "--arch", arch, "--shape", shape, *extra,
                 "--fabric", "gpu_nccl", "--out", str(out)],
                stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
        cells.append({"key": key, "arch": arch, "shape": shape, "proc": proc, "out": out,
                      "log": log, "t0": time.perf_counter()})
    return cells


def finish_dryrun_cells(cells, timeout: float = 300.0) -> dict:
    """Wait for phase 10a's runs (killing any still running at the end) and
    hold each record to the gates: exit 0, the JAX record's keys, the peak
    printed.  Returns ``{key: record}``, the key the arch with ``__<remat>``
    where the cell sets one."""
    records = {}
    try:
        for c in cells:
            rc = c["proc"].wait(timeout=max(1.0, timeout - (time.perf_counter() - c["t0"])))
            secs = time.perf_counter() - c["t0"]
            text = c["log"].read_text()
            if rc != 0:
                fail(f"phase 10a: {c['arch']} x {c['shape']}: exit {rc}\n{text[-3000:]}")
            rec = json.loads(c["out"].read_text())
            keys = DRYRUN_KEYS | ({"plan"} if rec["shape"] == "train_4k" else {"serve_plan"})
            if set(rec) != keys:
                fail(f"phase 10a: {c['arch']}: record keys {sorted(rec)} != the JAX record's "
                     f"{sorted(keys)}")
            if "peak_per_device_gib" not in text:
                fail(f"phase 10a: {c['arch']}: no peak_per_device_gib printed")
            mem, tot = rec["memory"], rec["totals"]
            groups = (rec["plan"]["analytic"]["schedule"]["groups"] if "plan" in rec
                      else rec["serve_plan"]["schedule"]["groups"])
            say(f"phase 10a: {c['key']} x {c['shape']} x {rec['mesh']} ({rec['n_devices']} fake "
                f"ranks): {secs:.1f} s; peak_per_device_gib {mem['peak_per_device_gib']} "
                f"({mem['peak_per_device_gib'] * 2**30 / 80e9:.1%} of 80 GB); whole step "
                f"{rec['whole_program']['flops_per_device']:.6e} flops/device, collectives "
                f"{rec['whole_program']['collectives']['counts']}; dominant {tot['dominant']}, "
                f"roofline_fraction {tot['roofline_fraction']:.6f}, bound "
                f"{tot['roofline_bound_s']:.6e} s (compute {tot['compute_term_s']:.6e}, memory "
                f"{tot['memory_term_s']:.6e}, collective {tot['collective_term_s']:.6e}); plan "
                f"groups ({len(groups)}) {groups}")
            by_op = [line.strip() for line in text.splitlines() if "collectives by op:" in line]
            say(f"phase 10a: {c['key']}: {by_op[0] if by_op else 'no collectives-by-op line'}")
            records[c["key"]] = rec
    finally:
        for c in cells:
            if c["proc"].poll() is None:
                c["proc"].kill()
                c["proc"].wait()
    return records


def _mem_tracker_peak(tracker) -> int:
    return int(sum(v["Total"] for dev, v in tracker.get_tracker_snapshot("peak").items()
                   if str(dev) != "meta"))


def dots_segment(cfg, B, S, device) -> dict:
    """Phase 10b's stage under ``remat='dots'``: its flops
    (``FlopCounterMode``) and peak allocated memory on the card, and the
    same on fake CUDA tensors (``MemTracker``), with the segment's time."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.segments import fake_tensors, stage_train_local

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run = stage_train_local(cfg, B, S, device, remat="dots", seed=0)
    with FlopCounterMode(display=False) as fc:
        run()
    torch.cuda.synchronize()
    out = {"flops": int(fc.get_total_flops()),
           "peak_bytes": int(torch.cuda.max_memory_allocated() - m0)}
    out["segment_ms"] = median_ms(run, reps=5, warmup=1)
    del run
    torch.cuda.empty_cache()
    with fake_tensors():
        tracker = MemTracker()
        with tracker, FlopCounterMode(display=False) as fake_fc:
            stage_train_local(cfg, B, S, device, remat="dots", seed=None)()
    out["fake_flops"] = int(fake_fc.get_total_flops())
    out["fake_peak_bytes"] = _mem_tracker_peak(tracker)
    say(f"phase 10b: the dots stage on the card: {out['flops']} flops, peak {out['peak_bytes']} B, "
        f"{out['segment_ms']:.4f} ms; on fake tensors {out['fake_flops']} flops, MemTracker's "
        f"peak {out['fake_peak_bytes']} B")
    return out


def dryrun_segment_on_card(device) -> dict:
    """Phase 10b's work on the card: one rank's TinyLlama train_4k stage
    segment (batch 1 x 4096, full width, plain attention, remat off, as the
    dry run counts it) under ``FlopCounterMode``, its peak allocated memory
    and ``MemTracker``'s peak for the same segment on fake CUDA tensors; then
    with ``attn_impl='flash'`` and remat, B3 / B4 / B5 at (1, 4096, 32/4, hd
    64): their launches in one segment, the segment's time, and the kernels
    checked and timed at that shape."""
    import dataclasses

    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.segments import fake_tensors, stage_train_local
    from repro_torch.launch.specs import arch_config_for_shape

    cfg = arch_config_for_shape("tinyllama-1.1b", "train_4k", cost_mode=True)
    B, S = 1, SHAPE_TRAIN_4K_SEQ
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run = stage_train_local(cfg, B, S, device, seed=0)
    with FlopCounterMode(display=False) as fc:
        run()
    torch.cuda.synchronize()
    out = {"flops": int(fc.get_total_flops()),
           "peak_bytes": int(torch.cuda.max_memory_allocated() - m0)}
    say(f"phase 10b: the stage segment on the card: {out['flops']} flops, peak "
        f"{out['peak_bytes']} B")
    del run
    torch.cuda.empty_cache()
    with fake_tensors():
        tracker = MemTracker()
        with tracker:
            stage_train_local(cfg, B, S, device, seed=None)()
    out["fake_peak_bytes"] = _mem_tracker_peak(tracker)
    say(f"phase 10b: MemTracker's peak of the same segment on fake tensors: "
        f"{out['fake_peak_bytes']} B")
    out["dots"] = dots_segment(cfg, B, S, device)

    # the same segment with the flash kernels, under remat as the trainer runs it
    run = stage_train_local(dataclasses.replace(cfg, attn_impl="flash"), B, S, device,
                            remat="full", seed=1)
    run()  # warm-up
    torch.cuda.synchronize()
    fa.reset_counts()
    run()
    torch.cuda.synchronize()
    out["launches"] = {name: fn.launches for name, fn in (
        ("fwd", fa.flash_attention_fwd), ("dq", fa.flash_attention_dq),
        ("dkv", fa.flash_attention_dkv))}
    out["plain_calls"] = sum(fn.ref_calls for fn in (
        fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv))
    out["segment_ms"] = median_ms(run, reps=7, warmup=1)
    say(f"phase 10b: the flash segment: launches {out['launches']}, {out['segment_ms']:.4f} ms")
    del run
    torch.cuda.empty_cache()
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    rel = {}
    check_flash_case(DRYRUN_ATTN, torch.bfloat16, device, 90, errs, rel=rel)
    torch.cuda.empty_cache()
    fb = check_fwd_bwd(DRYRUN_ATTN, device, 91)
    torch.cuda.empty_cache()
    say(f"phase 10b: flash fwd/dQ/dK-dV at {DRYRUN_ATTN[:5]} bf16 within tolerance of the plain "
        f"versions (max |diff| fwd {errs['fwd']:.3e}, dq {errs['dq']:.3e}, dkv {errs['dkv']:.3e}; "
        f"max |diff| / max|want| {fmt_rel(rel)}); fwd -> bwd through the kernels' own (o, lse): "
        f"{fmt_rel(fb)} (<= 1e-2)")
    out["errs"] = errs
    out["timings"] = time_flash(DRYRUN_ATTN, device, 92, "phase 10b", plain_reps=3)
    fa.reset_counts()
    return out


def check_dots_cell(records) -> None:
    """Phase 10a's TinyLlama train_4k cell under ``--remat dots`` against
    the ``full`` one: fewer flops a device by exactly the 2·M·N·K of the
    products ``'dots'`` saves (q, k, v, o, gate, up of every layer, at this
    device's tokens), which ``'full'`` recomputes; a peak no lower."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES

    full, dots = records["tinyllama-1.1b"], records["tinyllama-1.1b__dots"]
    cfg, shape = get_config("tinyllama-1.1b"), SHAPES["train_4k"]
    att = cfg.attention
    d, qd, kvd = cfg.d_model, att.n_heads * att.head_dim, att.n_kv_heads * att.head_dim
    per_token = d * qd + 2 * d * kvd + qd * d + 2 * d * cfg.d_ff
    tokens = shape.global_batch * shape.seq_len // full["n_devices"]
    want = 2 * tokens * per_token * cfg.n_layers
    f_full, f_dots = (r["whole_program"]["flops_per_device"] for r in (full, dots))
    p_full, p_dots = (r["memory"]["peak_per_device_gib"] for r in (full, dots))
    if f_full - f_dots != want:
        fail(f"phase 10a: full - dots = {f_full - f_dots} flops/device, the saved products' "
             f"2·M·N·K is {want}")
    if not p_full <= p_dots:
        fail(f"phase 10a: the dots peak {p_dots} GiB is below the full one {p_full} GiB")
    say(f"phase 10a: dots against full: flops/device {f_dots:.6e} against {f_full:.6e} (less by "
        f"{want:.6e} = the saved products' 2·M·N·K at {tokens} tokens a device), peak "
        f"{p_dots} against {p_full} GiB, collectives {dots['whole_program']['collectives']['counts']} "
        f"against {full['whole_program']['collectives']['counts']}")


def check_pinned_counts(rec) -> None:
    """Phase 10a's reduced cell: its collectives by kind, for the whole step
    and each segment, exactly ``DRYRUN_REDUCED_COUNTS`` (the counts
    ``tests/test_torch_dryrun.py`` pins), whatever the torch version."""
    import torch

    got = {"whole_program": rec["whole_program"]["collectives"]["counts"],
           **{name: rec["segments"][name]["coll_counts"] for name in ("stage", "head")}}
    if got != DRYRUN_REDUCED_COUNTS:
        fail(f"phase 10a: the reduced TinyLlama train_4k cell's collectives under torch "
             f"{torch.__version__} are {got}, pinned {DRYRUN_REDUCED_COUNTS}")
    say(f"phase 10a: the reduced TinyLlama train_4k cell's collectives under torch "
        f"{torch.__version__} equal the pinned counts: {got}")


def phase_dryrun(device) -> dict:
    """Phase 10: the dry-run CLI's cells on fake worlds (10a, on the
    host, in subprocesses started first) while one rank's stage segment runs
    for real on the card (10b); then 10b's gates against 10a's record."""
    cells = start_dryrun_cells()
    try:
        seg = dryrun_segment_on_card(device)
    finally:
        records = finish_dryrun_cells(cells)
    check_pinned_counts(records[DRYRUN_REDUCED_KEY])
    stage = records["tinyllama-1.1b"]["segments"]["stage"]
    if seg["flops"] != stage["flops"]:
        fail(f"phase 10b: the card's stage segment counts {seg['flops']} flops, the fake world's "
             f"per-device count is {stage['flops']}")
    real, fake = seg["peak_bytes"], seg["fake_peak_bytes"]
    if not abs(real - fake) <= DRYRUN_MEM_TOL * fake:
        fail(f"phase 10b: max_memory_allocated {real} B is not within {DRYRUN_MEM_TOL:.0%} of "
             f"MemTracker's fake peak {fake} B")
    dots = seg["dots"]
    if dots["flops"] != dots["fake_flops"]:
        fail(f"phase 10b: the card's dots stage counts {dots['flops']} flops, the fake tensors' "
             f"{dots['fake_flops']}")
    if not abs(dots["peak_bytes"] - dots["fake_peak_bytes"]) <= DRYRUN_MEM_TOL * dots["fake_peak_bytes"]:
        fail(f"phase 10b: the dots stage's max_memory_allocated {dots['peak_bytes']} B is not within "
             f"{DRYRUN_MEM_TOL:.0%} of MemTracker's fake peak {dots['fake_peak_bytes']} B")
    say(f"phase 10b: the dots stage (1 x {SHAPE_TRAIN_4K_SEQ}, plain attention): {dots['flops']} "
        f"flops = the fake tensors' count ({dots['flops'] - seg['flops']:+d} against the stage "
        f"with remat off: the batched products' recompute); max_memory_allocated "
        f"{dots['peak_bytes'] / 2**30:.4f} GiB against MemTracker's "
        f"{dots['fake_peak_bytes'] / 2**30:.4f} GiB "
        f"({(dots['peak_bytes'] - dots['fake_peak_bytes']) / dots['fake_peak_bytes']:+.2%}, within "
        f"{DRYRUN_MEM_TOL:.0%}); remat off {real / 2**30:.4f} GiB")
    check_dots_cell(records)
    if seg["launches"] != {"fwd": 2, "dq": 1, "dkv": 1} or seg["plain_calls"]:
        fail(f"phase 10b: flash launches {seg['launches']} and {seg['plain_calls']} plain calls in "
             f"one remat segment, expected 2 / 1 / 1 and none")
    t_ops = stage["flops"] / PEAK_FLOPS["bfloat16"]
    t_bytes = stage["bytes_accessed"] / HBM_BYTES_PER_S
    say(f"phase 10b: one rank's TinyLlama train_4k stage (1 x {SHAPE_TRAIN_4K_SEQ}, plain "
        f"attention): {seg['flops']} flops = the fake world's per-device count; "
        f"max_memory_allocated {real / 2**30:.4f} GiB against MemTracker's fake peak "
        f"{fake / 2**30:.4f} GiB ({(real - fake) / fake:+.2%}, within {DRYRUN_MEM_TOL:.0%})")
    say(f"phase 10b: the flash segment (remat): B3 / B4 / B5 launches {seg['launches']['fwd']} / "
        f"{seg['launches']['dq']} / {seg['launches']['dkv']}, 0 plain calls; "
        f"{seg['segment_ms']:.4f} ms against its roofline term {max(t_ops, t_bytes) * 1e3:.4f} ms "
        f"(the counted segment's flops / 989 TFLOP/s {t_ops * 1e3:.4f} ms, its unfused bytes / "
        f"3.35 TB/s {t_bytes * 1e3:.4f} ms)")
    return seg


def demangle(names: list[str]) -> list[str]:
    """Kernel names as ``name<template arguments>`` (c++filt, where the
    machine has it; else as ptxas gave them)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
    except OSError:
        return names
    if len(out) != len(names):
        return names
    return [x.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
            for x in out]


def report_ptxas(log: str) -> None:
    """One line per kernel of ptxas's report: registers, spills, shared memory."""
    rows, name, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "spill" in line:
            frame = line.split(":", 1)[-1].strip()
        elif "registers" in line:
            rows.append((name, f"{line.split(':', 1)[-1].strip()}; {frame}"))
    for shown, (_, props) in zip(demangle([n for n, _ in rows]), rows):
        say(f"ptxas: {shown}: {props}")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    t_start = time.perf_counter()
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.comm_pack.ops import SOURCE as PACK_SOURCE
    from repro_torch.kernels.flash_attention.ops import SM90_SOURCE as FLASH_SM90_SOURCE
    from repro_torch.kernels.flash_attention.ops import SOURCE as FLASH_SOURCE
    from repro_torch.kernels.rglru.ops import SOURCE as RGLRU_SOURCE
    from repro_torch.kernels.rwkv6_wkv.ops import SOURCE as WKV_SOURCE

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else "nvidia-smi unavailable"
    print(card, flush=True)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    # one nvcc each, in parallel
    built = _build.build_many([PACK_SOURCE, FLASH_SOURCE, FLASH_SM90_SOURCE, RGLRU_SOURCE,
                               WKV_SOURCE])
    say(f"build: all five libraries in {time.perf_counter() - t0:.1f} s")
    for src, (lib, log, secs) in built.items():
        say(f"build: {lib.name} ({secs:.1f} s)" + ("" if log else " (already built)"))
        report_ptxas(log)

    lap = [time.perf_counter()]

    def took(what: str) -> None:  # each group of phases' seconds, for the budget
        now = time.perf_counter()
        say(f"{what}: {now - lap[0]:.1f} s")
        lap[0] = now

    errs, timings = phase_kernels(device)
    flash_errs, flash_timings = phase_flash(device)
    rglru_errs, rglru_timings = phase_rglru(device)
    rg_flash_errs, rg_flash_timings = phase_rg_flash(device)
    wkv_errs, wkv_timings = phase_wkv(device)
    took("phases 1-1d")
    new_flash = phase_new_flash(device)
    took("phase 1e")
    phase_reduced_model(device)
    phase_reduced_model(device, "recurrentgemma-9b", seq=128, tag="phase 2b")
    phase_reduced_model(device, "rwkv6-7b", seq=64, tag="phase 2c")
    for arch in ("gemma2-2b", "mixtral-8x7b", "dbrx-132b", "musicgen-large", "qwen2-vl-2b"):
        phase_reduced_model(device, arch, seq=128, tag=f"phase 2d {arch}")
    took("phases 2-2d")
    try:
        counts, dag = phase_full_width(device)
        took("phase 3")
        rg_counts = phase_rg_full_width(device)
        rwkv_counts = phase_rwkv_full_width(device)
        took("phases 3b-3c")
        new_counts = phase_new_full_width(device)
        took("phases 3d-3j")
        p4_counts, p4_sim = phase_autotune(device, dag)
        p5_counts = phase_restart(device)
        took("phases 4-5")
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    serve_errs, serve_timings, serve_cells = phase_serve(device)
    p7 = phase_resilience(device)
    took("phases 6-7")
    p8 = phase_sharded(device)
    p9 = phase_sim(device, p4_sim, serve_cells["phase 6a"], card)
    took("phases 8-9")
    p10 = phase_dryrun(device)
    took("phase 10")
    say(f"all phases, the build included: {time.perf_counter() - t_start:.1f} s")

    main_cfg = timings["float32"]  # the main path's wire
    kernels = []
    for name, src_line in (("pack", 49), ("unpack", 194)):
        t = main_cfg[name]
        kernels.append({
            "name": f"comm_pack.{name}",
            "route": "cuda",
            "source": PACK_SRC,
            "replaces": f"src/repro/kernels/comm_pack/kernel.py:{src_line}",
            # phases 3, 3b-3j, 4 and 5 (their training steps) and 9d's training
            # example, each counted from 0 around its own runs
            "launches": (counts[f"{name}_launches"] + rg_counts[f"{name}_launches"]
                         + rwkv_counts[f"{name}_launches"]
                         + sum(c[f"{name}_launches"] for c in new_counts.values())
                         + p4_counts[f"{name}_arena"] + p5_counts[f"{name}_arena"]
                         + p9[f"{name}_launches"]),
            "max_abs_err": errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": t["library_ms"],
        })
    # the flash kernels once per configuration: TinyLlama's (phase 1b, run
    # 3), RecurrentGemma's MQA / hd 256 / window 2048 (phase 1c, run 3b) and
    # each new cell's (phase 1e, run 3d-3h).  A new shape's launches are its
    # run's launches with a window if the shape has one, else those without
    # (Gemma2's local and global layers split run 3f's so)
    configs = [("", flash_errs, flash_timings, counts, p4_counts, p5_counts),
               ("[recurrentgemma]", rg_flash_errs, rg_flash_timings, rg_counts, {}, {})]
    for tag, (f_errs, f_timings) in new_flash.items():
        c = new_counts[tag.split()[0]]
        windowed = dict(NEW_ATTN)[tag][6] is not None
        configs.append((f"[{tag}]", f_errs, f_timings, {
            f"{n}_launches": c[f"{n}_windowed_launches"] if windowed
            else c[f"{n}_launches"] - c[f"{n}_windowed_launches"]
            for n in ("flash_fwd", "flash_dq", "flash_dkv")}, {}, {}))
    for suffix, f_errs, f_timings, f_counts, f_more, f_restart in configs:
        for name, replaces in (
                ("fwd", "src/repro/kernels/flash_attention/kernel.py:40"),
                ("dq", "src/repro/kernels/flash_attention/kernel_bwd.py:53"),
                ("dkv", "src/repro/kernels/flash_attention/kernel_bwd.py:89")):
            t = f_timings[name]
            kernels.append({
                "name": f"flash_attention.{name}{suffix}",
                "kernel": f"flash_{name}_sm90",  # the C entry point in ``source``
                "route": "cuda",
                "source": FLASH_SM90_SRC,
                "replaces": replaces,
                # phase 3 (3b) and, for TinyLlama's, phases 4's and 5's training steps
                "launches": (f_counts[f"flash_{name}_launches"]
                             + f_more.get(f"flash_attention_{name}", 0)
                             + f_restart.get(f"flash_attention_{name}", 0)),
                "max_abs_err": f_errs[name],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
            })
    # the backward has no Pallas kernel: it stands in for JAX's autodiff of
    # the associative scan that the JAX model runs
    for name, replaces in (("fwd", "src/repro/kernels/rglru/kernel.py:31"),
                           ("bwd", "src/repro/models/rglru.py:88")):
        t = rglru_timings[name]
        kernels.append({
            "name": f"rglru.{name}",
            "route": "cuda",
            "source": RGLRU_SRC,
            "replaces": replaces,
            "launches": rg_counts[f"rglru_{name}_launches"],
            "max_abs_err": rglru_errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    # the backward has no Pallas kernel: it stands in for JAX's autodiff of the
    # chunked form that the JAX model runs
    for name, replaces in (("fwd", "src/repro/kernels/rwkv6_wkv/kernel.py:31"),
                           ("bwd", "src/repro/models/rwkv6.py:177")):
        t = wkv_timings[name]
        kernels.append({
            "name": f"rwkv6_wkv.{name}",
            "route": "cuda",
            "source": WKV_SRC,
            "replaces": replaces,
            "launches": rwkv_counts[f"wkv_{name}_launches"],
            "max_abs_err": wkv_errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    # the serving path (phase 6's CUDA-graph runs): B3 in each prefill, B6 and
    # B7 in each prefill and decode step, each timed in that mode.  The wrappers
    # count the prefills and the capture's recording; a replay's launches are
    # read by name from the device trace
    graph_counts = {tag: c["counts"]["graph"] for tag, c in serve_cells.items()}
    for name, source, replaces, key, counter, err, extra in [
            (f"flash_attention.fwd[serve {key[6:-1]}]", FLASH_SM90_SRC,
             "src/repro/kernels/flash_attention/kernel.py:40", key, (tag, "flash_fwd"), "flash",
             {"kernel": "flash_fwd_sm90"}) for tag, key, _ in SERVE_ATTN] + [
            ("rglru.fwd[serve]", RGLRU_SRC, "src/repro/kernels/rglru/kernel.py:31", "decode",
             ("phase 6b", "rglru_fwd"), "rglru", {"kernel": "rglru_step_kernel"}),
            ("rwkv6_wkv.fwd[serve]", WKV_SRC, "src/repro/kernels/rwkv6_wkv/kernel.py:31", "wkv",
             ("phase 6c", "wkv_fwd"), "wkv", {})]:
        t = rglru_timings[key] if key == "decode" else serve_timings[key]
        cell = serve_cells[counter[0]]
        per_replay = cell["prof"]["graph"]["named"][
            {"wkv_fwd": "wkv_fwd_state", "rglru_fwd": "rglru_step"}.get(counter[1], counter[1])]
        launches = graph_counts[counter[0]][counter[1]]
        if name == "rglru.fwd[serve]":
            # B6's launches inside the prefills (the tiled kernel, read around each prefill)
            # have a row of their own below; this row keeps the decode steps run in Python
            launches -= cell["prefill_launches"]
        kernels.append({
            "name": name, **extra, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "graph_replays": cell["replays"], "launches_per_replay": int(per_replay),
            "max_abs_err": serve_errs[err], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    # B6 in 6b's prefills (the tiled kernel), checked and timed at the longest prompt's
    # (1, 2304, 4096) in phase 1c
    t, cell = rglru_timings["prefill"], serve_cells["phase 6b"]
    kernels.append({
        "name": "rglru.fwd[prefill]", "kernel": "rglru_fwd_kernel", "route": "cuda",
        "source": RGLRU_SRC, "replaces": "src/repro/kernels/rglru/kernel.py:31",
        "launches": cell["prefill_launches"], "max_abs_err": rglru_errs["prefill"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    })
    # phase 7 (resilient serving and the fleet): B3 in every prefill, fresh, re-admitted
    # after a restore or resumed after a failover; B6 in 7b's prefills and decode steps.
    # Times as phase 6's rows (the same kernels at the same shapes)
    p7a, p7b, p7c = p7["7a"], p7["7b"]["cell"], p7["7c"]
    for name, key, launches, extra in (
            ("flash_attention.fwd[resilient tinyllama]", "flash[tinyllama]",
             p7a["greedy"]["counts"]["flash_fwd"] + p7a["sampled"]["counts"]["flash_fwd"]
             + sum(r["counts"]["flash_fwd"] for r in p7c["runs"])
             + p7c["wall_counts"]["flash_fwd"], {}),
            ("flash_attention.fwd[resilient recurrentgemma]", "flash[recurrentgemma]",
             p7b["counts"]["flash_fwd"], {})):
        t = serve_timings[key]
        kernels.append({
            "name": name, "kernel": "flash_fwd_sm90", "route": "cuda", "source": FLASH_SM90_SRC,
            "replaces": "src/repro/kernels/flash_attention/kernel.py:40", "launches": launches,
            "max_abs_err": serve_errs["flash"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **extra,
        })
    # B6 inside 7b's prefills (read around each) and in its decode steps run in Python
    for name, kern, key, launches, err, extra in (
            ("rglru.fwd[resilient prefill]", "rglru_fwd_kernel", "prefill",
             p7b["prefill_launches"], rglru_errs["prefill"], {}),
            ("rglru.fwd[resilient serve]", "rglru_step_kernel", "decode",
             p7b["counts"]["rglru_fwd"] - p7b["prefill_launches"], serve_errs["rglru"],
             {"graph_replays": p7b["graph_replays"],
              "launches_per_replay": int(p7["7b"]["prof"]["named"]["rglru_step"])})):
        t = rglru_timings[key]
        kernels.append({
            "name": name, "kernel": kern, "route": "cuda", "source": RGLRU_SRC,
            "replaces": "src/repro/kernels/rglru/kernel.py:31", "launches": launches,
            **extra, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    # phase 8 (sharded serving on a one-rank NCCL group): B3 in every prefill of 8a's engines
    # and 8c's launcher runs (TinyLlama's serve shape) and of 8b's (Mixtral's, window 4096),
    # each checked and timed in phase 8 as phase 6's rows are
    for name, key, launches, err in (
            ("flash_attention.fwd[sharded serve tinyllama]", "tinyllama", p8["b3_tinyllama"],
             serve_errs["flash"]),
            ("flash_attention.fwd[sharded serve mixtral-8x7b]", "mixtral", p8["b3_mixtral"],
             p8["errs"]["fwd"])):
        t = p8["timing"][key]
        kernels.append({
            "name": name, "kernel": "flash_fwd_sm90", "route": "cuda", "source": FLASH_SM90_SRC,
            "replaces": "src/repro/kernels/flash_attention/kernel.py:40", "launches": launches,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    # phase 10b: B3-B5 in one rank's train_4k stage segment (its remat run)
    for name, replaces in (("fwd", "src/repro/kernels/flash_attention/kernel.py:40"),
                           ("dq", "src/repro/kernels/flash_attention/kernel_bwd.py:53"),
                           ("dkv", "src/repro/kernels/flash_attention/kernel_bwd.py:89")):
        t = p10["timings"][name]
        kernels.append({
            "name": f"flash_attention.{name}[dryrun stage tinyllama]",
            "kernel": f"flash_{name}_sm90", "route": "cuda", "source": FLASH_SM90_SRC,
            "replaces": replaces, "launches": p10["launches"][name],
            "max_abs_err": p10["errs"][name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
