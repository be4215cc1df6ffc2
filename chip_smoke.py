#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (the
seven TPU kernels', the kTLS-analogue bench's two and the prefill's
float32 product, nine sources) into
``build/kernels/`` (one ``nvcc`` per source, all at once) and then runs
the 23 phases below, in order but where a phase says when it runs:

1. **parity** -- each datapath kernel against its plain PyTorch version on
   the card, on seeded cases at the deployment shapes and at small ragged
   ones, with every optional operand on and off: ``fused_round`` at ring
   depths ``n_buffers`` 0, 2, 3, 4 and 8 (every depth phase 11 may pick),
   also on edge rows (a payload window off its 16-byte boundary; S = 31,
   the 4-byte copy path), a 70 x 40 policy table (read from global
   memory) and pages of two tiles;
   ``selective_gather`` also at a page of 6 tokens and of two tiles;
   ``selective_copy`` also on rows at the edges of its 16-byte groups
   (``meta_len % 4`` and ``S % 4`` each 0 to 3, payloads ending at S or
   cut by it, ``-1`` slots between valid ones) in the deployment's pool,
   at a page of 6 tokens and of 2048; ``policy_match`` also at R x K = 32,
   R = 33, K = 33, payload positions past W and past ``payload_len``, an
   odd M, rows too wide to stage in shared memory, and every combination
   of keystream, live column and payload window present or absent.
   Outputs must be bit-identical (``torch.equal``, the whole pool after the
   in-place anchor included) and the pool tensor must keep its storage.
2. **e2e plaintext** -- a policy-routed ``ProxyRuntime(batched=True)`` of 64
   channels x 16 messages (256 metadata tokens, 4096-16384 payload tokens)
   over a ``LibraStack(n_shards=4, pages_per_shard=8192, page_size=1024)``:
   a 128 MiB resident pool. Run as ``fused-round`` (one kernel per round),
   ``auto`` (three kernels per round) and ``host``, the device paths twice
   in turns. Wire bytes, counters and verdicts must agree, no O(pool) sync
   may happen, every page must come back, and each device run must have
   launched its kernels.
3. **e2e hw-kTLS** -- the same with ``tls="hw"`` sockets (RX, TX and
   metadata keystreams through the kernels).
4. **trace** -- the device's busy share of one plaintext run per device
   path (``torch.profiler``), and the round assembly split out: the
   traced stack's ``recv_batch`` and ``forward_batch`` wrapped on the
   instance under profiler labels, each one's host seconds, share of the
   run's wall and the device time launched under it.
5. **attn_parity** -- the two attention kernels against their plain
   versions on the card (``atol = rtol = 1e-4``): GQA groups 1 to 4 and 8
   (and 12 for paged attention), 36 heads of 64, every head dim the
   wrappers take (16 to 128), ``-1`` table slots, windows, lengths that
   are no multiple of a tile, pages of two tiles, a table of 70 slots, and
   the serving shapes of phases 6, 15 to 19 (the prefill of a full
   wave and a decode step of it; paged attention also at B=1); hymba's
   (phase 17: 25 query heads over 5 KV heads of 64) both global and over
   its window of 1024, as its layers attend; internvl2's (phase 18: a
   causal prefill of 4 x 768, 64 over 8 heads of 128; a decode step over
   776 keys at group 8); whisper's (phase 19: the decoder's causal
   prefill of 8 x 32 and decode step, 16 heads of 64, and its two
   non-causal prefill calls with ``Sq != Skv``: the encoder's 1500 frames
   and the prompt's 32 queries, each over the 1536 keys
   ``attention.noncausal_attention`` pads them to); non-causal cases with
   ``Sq`` above and below ``Skv``, ``Skv`` no multiple of 64.
6. **serve** -- ``LibraEngine`` serving ``phi4-mini-3.8b`` at full width
   and depth (3.84 B float32 parameters from a fixed seed on the card): 16
   requests of 1024 tokens (8-token header) in two waves of 8, 32 new
   tokens each, run once through the kernels (``attn_impl='auto'``) and
   once through their plain versions (``'ref'``) on the same parameters.
   ``EngineStats``, ``CopyCounters`` and the output tokens must be
   identical (a token may differ only where the plain run's top-2 logit
   margin is below 1e-3 of the logits' spread), every page must come
   back, and each kernel must have launched. Prints tokens/s, p99 latency,
   time to first token, peak device memory, launches, and a profiler split
   of one decode step.
7. **mlstm_parity** -- the mLSTM kernel against the plain chunked version
   on the card, ``h`` and the final ``(C, n, m)``: the JAX package's test
   shapes (``atol = rtol = 5e-4``), its gate extremes (3e-3), S that is no
   multiple of the chunk, at least one case for every ``(dh, chunk)`` the
   wrapper instantiates (``HEAD_DIMS x CHUNKS``, 12 pairs), and the xLSTM
   run's shape (B=8, H=4, S=4096, dh=512, chunk 64).
8. **xlstm_serve** -- ``XLSTMModel`` of ``xlstm-350m`` at full width and
   depth (528 M float32 parameters from a fixed seed): 8 prompts of 4096
   tokens, one ``prefill`` and 31 greedy ``decode_step``s, once through
   the kernel (``mlstm_impl='auto'``) and once through the plain version
   (``'ref'``). Tokens must be identical under the near-tie rule of phase
   6, the decode state after prefill must lie no farther from that of a
   run whose scans are computed in float64 than twice the plain run's
   distance, a control whose scans take bfloat16-rounded inputs must fail
   that rule, and the kernel must have launched once per mLSTM block
   (21). Prints each run's ratio to the plain run's distance, prefill
   seconds, ms per decode step, tokens/s, peak device memory and a
   profiler split of the prefill.
9. **timing** -- each kernel, its plain version and (where one exists) a
   single PyTorch library call at the main path's shapes: CUDA events
   around each launch, L2 flushed before it, median of 30 launches (the
   datapath kernels also after a 64 MB read that leaves the L2 clean,
   ``fused_round`` at each ring depth, ``selective_gather`` beside a
   ``copy_`` of as many bytes as it writes; a kernel that returns at once,
   the timing's floor, on a line of its own and beside the
   ``selective_copy`` and ``policy_match`` rows); the
   bound is the larger of the bytes the function must move over 3.35 TB/s
   and its operations over the card's peak for their type (int32 for the
   datapath, float32 FMA for paged attention; for flash attention and the
   mLSTM scan three TF32 tensor-core products per float32 product, with
   the float32-FMA bound beside it as ``fp32_fma_bound_ms``). Both
   attention kernels also at hymba's windowed shapes (phase 17), the
   bounds counting only the keys the window keeps, flash attention beside
   ``scaled_dot_product_attention`` with the band as its mask; and at
   the shapes of phases 18-19 (rows marked ``shape_of``): both decode
   steps, internvl2's causal prefill and whisper's two non-causal calls,
   whose bound counts the whole ``Sq x Skv`` rectangle, beside
   ``scaled_dot_product_attention`` (float32, non-causal).
10. **cluster** (run right after phase 4) -- phase 2's deployment as a
   ``LibraCluster`` of four workers, each with its own 128 MiB resident
   pool (512 MiB on the card) and a clone of the policy table, under
   ``ClusterRuntime(work_stealing=False)``. Channel i's source is on
   worker i % 4; both destinations are on the next worker for the first
   16 channels (25 % of the flows cross workers, each handoff a zero-copy
   grant gathered out of the owner's pool) and on its own worker
   otherwise. Plaintext as ``fused-round``, ``auto`` and ``host`` under
   ``run()`` and as ``fused-round`` and ``host`` under
   ``run_parallel(threads=True)``; hw-kTLS as ``fused-round`` and
   ``host`` under ``run()``. Within a TLS mode wire bytes, aggregate
   ``CopyCounters``, policy verdicts and cluster stats must be identical;
   wire bytes and counters must equal a single ``LibraStack`` run of the
   same traffic; grants must happen; every worker of a device run must
   run device rounds with no pool sync, no host gather and no device
   fallback, and launch the kernels of its path (and no others); and
   shutdown must find every pool free with no grant pin left. Then three
   directed cases: (a) every flow crossing to a worker above its
   watermark (each handoff a one-copy read of the owner's device-truth
   rows), ``fused-round`` against ``host``; (b) a message taken in by a
   ``fused-round`` round, granted, and its owner killed: the grant is
   copied out of the dying pool and transmits byte for byte; (c) the
   chaos scenario of ``scripts/check_failover_recovery_torch.py`` as
   ``fused-round`` rounds, under ``run()`` and under threads. Prints each
   run's seconds, rounds/s and msgs/s, the threads' per-worker seconds,
   the grant, copy and kill stats and the launches per kernel.
11. **depth** (run right after phase 10) -- the fused round's ring depth
   on the main path. ``kernels/dma_profile.profile_fused_depths`` on the
   card at ``n_buffers`` 0, 2, 3, 4 and 8, plaintext and with both
   keystreams, at two shapes: the datapath cell's round (64 rows x 17
   tasks, pages of 1024 tokens, 16 pages a row, 256 metadata tokens) and
   the N = 256 point of ``benchmarks/bench_batched_datapath.py`` (256
   rows, 4352 tasks); each depth's ring, best wall-clock round and best
   CUDA-event kernel time, ``dma_compute_profile`` at the picked depth and
   ``auto_buffer_depth``'s pick (the least kernel time). Then phases 2 and 3's ``fused-round``
   runs with ``stack.pool.fused_buffers`` at 0, at the depth picked at
   the N = 256 shape with both keystreams, and at the depth
   ``auto_buffer_depth`` returns under ``LIBRA_FUSED_BUFFERS=4`` (which
   must be 4), beside ``host``: wire bytes, counters and verdicts
   identical to ``host`` and to the default depth's run, ``xfer``
   identical to the default depth's, and every ``fused_round`` launch of
   a run at the ring depth its ``fused_buffers`` names
   (``selective_copy.FUSED_DEPTHS``).
12. **baselines** (run right after phase 6, on its parameters and
   prompts) -- ``StandardEngine``, ``CopierEngine`` and
   ``StaticEngine(memory_budget=`` the bytes of phase 6's KV pool, 8 slots
   ``)``, each once through the kernels (``attn_impl='auto'``). Tokens must
   equal the Libra kernel run's under phase 6's near-tie rule (margins from
   its plain run); Standard and Copier must agree in
   ``payload_copy_bytes``, ``steps``, ``prefills`` and ``h2d_bytes``;
   Copier must download once a step and Standard once per active request a
   step; ``payload_copy_bytes`` must be the steps times the cache's bytes
   (none under Static) plus every prompt's prefill KV, and 0 for Libra;
   the cache must move to new storage every Standard and Copier step and
   stay in place under Static; ``flash_attention`` must launch once a
   layer a prefill (64) and ``paged_attention`` never. Prints each
   engine's tokens/s, p99 latency, time to first token, peak device
   memory, ms per decode step and ``EngineStats``, and a profiler split of
   one full-batch Standard decode step (cache copy, matmuls, dense
   attention, transfers, host gaps).
13. **benches** (run right after phase 11) -- the port's smoke benches
   (``benchmarks_torch.run``'s ``SMOKE_BENCHES`` but ``cluster_proxy`` and
   ``chaos_proxy``, whose wall-clock gates depend on how the host schedules
   threads and whose paths phase 10 holds on the card) through the
   port's runner in this process, under ``LIBRA_BENCH_SMOKE=1`` (restored
   after), once on the card and once on the CPU (the plain versions),
   artifacts in a temporary directory. No ``ERROR`` row, no bench without
   rows, no identity field false, no pool sync, host gather or device
   fallback on a resident-pool row; the CUDA run's rows equal to the CPU
   run's once the wall clock's fields are dropped
   (``benchmarks_torch.common.untimed``; ``dma_overlap``'s by name only,
   its depth pick being by kernel time on the card); ``selective_copy``,
   ``selective_gather``, ``policy_match``, ``fused_round``,
   ``paged_attention`` and ``flash_attention`` each launched by the CUDA
   run, nothing by the CPU run.
14. **audit** (run right after phase 3, on its deployment) -- the port's
   verifier (``repro_torch.analysis``) on the card. The five passes
   through ``python -m repro_torch.analysis``'s ``main`` (ownership, the
   kernel audit on the card, lockset, concurrency, imports): exit 0, no
   active finding. The kernel registry on the card: every entry one launch
   of its kernel (``torch.profiler`` events by name and the wrappers'
   counts), no pool copy and no allocation of the pool's bytes beside the
   outputs, int32 throughout, its boundary elements as declared and no
   copy across the boundary, the pool in place; the negative control (a
   call on a copy of the pool) flagged ``KERN002``.
   ``kernel_audit.audit_rounds`` of ``fused-round`` plaintext,
   ``fused-round`` hw-kTLS and ``auto`` plaintext runs: kernel events
   equal to the wrappers' launches and to the round counters
   (``fused_round`` = Δ``fused_rounds``; a missed TX speculation's gather
   its own launch), ``Memcpy`` bytes equal to the ``xfer`` token deltas at
   int32 plus the int64 row ids ``DevicePool._index`` uploads (and the
   policy match's operands and verdicts, which no counter counts: waived
   at their line), the peak allocation below the 128 MiB pool, the pool's
   ``data_ptr`` stable, no int64 device tensor wider than a round's table.
   Then ``scripts/check_kernel_parity_torch.py``: its shape sweeps, kernel
   against plain version bit for bit, each shape through the audit.

15. **moe_serve** (run right after phase 12, once phases 6 and 12 have
   freed their parameters) -- ``LibraEngine`` serving
   ``qwen2-moe-a2.7b`` at full width and depth (24 layers, 60 experts
   padded to 64, top-4, 4 shared; 15.15 B float32 parameters from a fixed
   seed, 60.6 GB): 8 requests of 512 tokens (8-token header) in one wave,
   16 new tokens each; then ``qwen3-moe-30b-a3b`` at full width (128
   experts, top-8, GQA 32/4, qk-norm) with 12 of its 48 layers (8.1 B
   parameters, 32.4 GB; the whole model is 122 GB): 4 requests of 512
   tokens, 8 new. Each once through the kernels (``attn_impl='auto'``)
   and once through the plain versions (``'ref'``) on the same
   parameters, freed before the next config. ``EngineStats`` and
   ``CopyCounters`` identical, every page back, ``flash_attention``
   launched layers x prefills and ``paged_attention`` layers x decode
   steps times on the kernel run and never on the plain run, tokens
   identical under phase 6's near-tie rule or, from the first step at
   which the plain run's router had a top-k boundary margin (k-th against
   (k+1)-th probability) below 1e-6 in some layer, excused by it (each
   case printed with its margin), and the entries dropped past an
   expert's capacity equal in both runs (the combine adds a token's
   ``k`` terms in another order than the reference). Prints per run tokens/s, p99,
   time to first token, ms per decode step, peak device memory, seconds,
   dropped entries by step, the plain run's router margins by step, and a
   profiler split of one full-batch decode step: the MoE block's router,
   dispatch, expert products, combine and shared experts apart from the
   attention and the head.
16. **dense_configs** (right after phase 15) -- ``minicpm-2b`` (36 heads
   of 64, tied head scaled by 1/9, residual branches by 1.4/sqrt(40);
   10.9 GB) and ``mistral-nemo-12b`` (GQA 32/8, head dim 128, q_dim 4096
   under d_model 5120; 49.0 GB) at full width and depth, one after the
   other and freed between: 4 requests of 256 tokens, 8 new, ``auto`` and
   ``'ref'``, under phase 15's rules but the router's; the split shows
   the MLP in place of the MoE block.
17. **hybrid_serve** (right after phase 16) -- ``hymba-1.5b`` at full
   width and depth (32 layers, each a Mamba mixer beside its attention;
   GQA 25/5 of 64; a window of 1024 on 29 layers, layers 0, 15 and 31
   global; 1.66 B float32 parameters, 6.65 GB): 8 requests of 1280 tokens
   (past the window, so it applies at prefill and decode) in two waves of
   4, 16 new each; the second wave decodes from the SSM rows the first
   left (a fault of the reference, carried). ``auto`` and ``'ref'`` under
   phase 16's rules; where no token diverged, the engines' final
   ``ssm_state`` within ``SSM_STATE_TOL`` of each other; the split labels
   ``mamba_step`` (``ssm``) and prints its share of a step's device time.
18. **vlm_serve** (right after phase 17) -- ``internvl2-76b`` at full
   width (d_model 8192, GQA 64/8 of 128, d_ff 28672, vocabulary 128256)
   with 16 of its 80 layers (16.86 B float32 parameters, 63.4 GB; the
   whole model is 282.5 GB), driven through ``prefill`` / ``decode_step``
   (the engines feed no image, as the JAX package's cannot) on a
   ``PagedKVPool`` of page 16: 4 requests, each an image of 256 seeded
   patch embeddings ``[256, 8192]`` projected by ``img_proj`` and 512
   text tokens, all 768 positions anchored at prefill, 8 new tokens at the
   prefix-inclusive positions (``extend`` and ``write_coords`` each step).
   Once through the kernels and once through the plain versions: tokens
   under phase 6's near-tie rule, ``flash_attention`` 16 launches a
   prefill and ``paged_attention`` 16 a step (none in the plain run),
   every page back. Prints seconds, time to first token, ms a decode step,
   tokens/s, peak memory, and profiler splits of the prefill and of a
   step (the ``img_proj`` product, attention, MLP, head, the rest).
19. **encdec_serve** (right after phase 18) -- ``whisper-medium`` at full
   width and depth (24 encoder and 24 decoder layers, 16 heads of 64;
   758,123,520 parameters, 3.03 GB): 8 requests of 1500 seeded frame
   embeddings and a decoder prompt of 32 tokens, 32 new each; the cross
   K/V of every decoder layer (``cross_kv [24, 8, 1500, 2, 16, 64]``,
   2.36 GB) computed once and read in place by every step. ``auto`` and
   ``'ref'`` under phase 18's rules; ``cross_kv`` of both runs within
   ``atol = rtol = 1e-4``; ``flash_attention`` 72 launches a prefill (24
   encoder, 24 self, 24 cross), ``paged_attention`` 24 a step. Prints the
   encoder's seconds apart from the decoder's prefill, ms a step,
   tokens/s, peak memory, and the cross-attention's share of a step's
   device time.
20. **train** (last, after phase 9) -- training, which reaches none of
   the seven kernels (the reference trains through jnp functions): none
   may launch during the phase, and ``flash_attention`` must refuse an
   input that requires gradients. (a) ``Trainer`` on libra-proxy-125m at
   full size (162 M parameters), ``SyntheticCorpus(seed=0)``, 8 x 512,
   ``AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=200)``,
   ``remat="none"``, 30 steps with a checkpoint at step 10: the mean loss
   of the last 5 steps below the first 5's less 0.5; a fresh ``Trainer``
   resumes the checkpoint and its 5 losses are within 1e-5 of the
   continued run's; a simulated preemption then writes its checkpoint at
   step 15. (b) phi4-mini-3.8b at full width, 16 of its 32 layers (2.23 B
   parameters, 35.6 GB of parameters, gradients and moments), 2 x 2048,
   ``remat="full"``, 3 steps: every layer through ``blockwise_attention``
   and its backward, losses finite and gradient norms positive. For both,
   ms a step, tokens/s, peak memory, and a profiled step's device time
   split into the forward, the remat rerun, the blockwise backward, the
   other backward products, the head and AdamW, with the host gaps and
   the device's busy share. (c) ``blockwise_attention``'s output and
   backward against autograd through ``dense_attention`` at phi4-mini's
   head shapes (2 x 2048, 24/8 heads of 128; causal, window 1024, and
   1500 queries over 1536 keys non-causal), float32 within ``atol = rtol
   = 1e-5`` and bfloat16 within 1e-2 by relative norm; every reduced
   config's ``loss_fn`` and gradients on the card against the CPU from the
   same parameters, within bars set from the card's own readings (the
   loss within 1e-3, each gradient within 3e-2 and all together within
   2e-2 by relative norm), and a control run on the card from parameters
   rounded to float8 (e4m3) must break them; and at the reduced config of
   every arch the ``Trainer`` feeds (tokens alone: not vlm, encdec), 2 x
   128 positions, the exact-resume twin of (a) within 1e-5 (MoE
   included; the xLSTM's mLSTM blocks run two chunks).
21. **mesh** (after phase 20) -- the port's mesh on the one card: a
   one-rank NCCL group (``init_method`` on 127.0.0.1) and a
   ``(data=1, model=1)`` ``DeviceMesh`` on ``cuda``; NCCL must start (no
   fallback to another backend or to the mesh-less path). (a)
   phi4-mini-3.8b at full width and depth driven through ``prefill`` /
   ``decode_step`` on a ``PagedKVPool``, 4 requests of 256 tokens, 8 new:
   once without a mesh and once through the mesh keywords with every
   input a DTensor (the parameters placed by the serving rules), each
   run launching ``flash_attention`` once a layer a prefill and
   ``paged_attention`` once a layer a step; the tokens must be identical.
   Prints each run's wall ms a step and a profiled step's device ms (the
   paged attention and its combine's all-reduces apart). (b)
   libra-proxy-125m at full size: a mesh-less ``Trainer`` checkpoints at
   step 5, a ``Trainer(mesh=...)`` resumes it onto the mesh's placements,
   and its 3 losses must be within 1e-5 of the continued run's. (c)
   ``compressed_psum`` of a seeded 4096 x 4096 gradient: within 2e-2 of
   the exact mean, the residual its quantisation error. The group is
   destroyed; then (d) the dry-run of phi4-mini-3.8b ``decode_32k`` on
   the single pod (rank 0 of a 256-rank fake group, fake CPU tensors),
   its memory, counts and roofline terms on the H100 row printed.
22. **ktls_analogue** (after phase 21) -- the kTLS-analogue bench
   (``benchmarks_torch/bench_ktls_analogue.py``, ``fig6c_ktls``): decode
   attention of q ``[8, 12, 64]`` over every key of kv ``[8, ctx, 2, 12,
   64]`` with no scale and no mask, at ctx 256, 1024 and 4096, on the
   bench's draws. ``ktls_dequant`` against its plain version bit for bit
   (and the plain version on the card against the CPU's), also with
   ``q = 1`` over every float32 bit pattern as ``amax``;
   ``ktls_attention`` over float32 K/V and over int8 K/V with ``amax``
   (dequantised in registers) against its plain version within
   ``atol = rtol = 1e-4``, the error printed. Then ``benchmarks_torch.run
   --only fig6c_ktls --device cuda`` in this process, into a temporary
   directory: no ``ERROR`` row, every row, each regime's kernel launched
   6 times a context (``plain`` and ``sw`` over float K/V, ``hw`` over
   int8, ``sw``'s dequantise pass). Prints each regime's µs as the bench
   timed it, and CUDA-event times (clean L2) of each kernel, regime and
   plain version and of ``scaled_dot_product_attention`` (scale 1) beside
   the float attention, each beside its bound (bytes over 3.35 TB/s:
   201.3 MB plain, 53.5 MB hw, 456.1 MB sw at ctx 4096). Whether ``hw <
   plain < sw`` holds is recorded, not checked.
23. **proxy_serving** (after phase 22) -- ``examples/proxy_serving_torch.py``
   on the card: (a) the script as a subprocess with no arguments must
   exit 0, its stream part printing the lines the CPU's
   ``stream_proxy("cpu")`` prints; (b) its ``serving_proxy`` loop with
   the full libra-proxy-125m (12 layers, d_model 768; parameters from
   ``init_params(0)``), 8 requests of 44 tokens, 6 new, through the
   kernels and through the plain versions: tokens under phase 6's
   near-tie rule, ``EngineStats``, ``CopyCounters``, the printed lines
   (VPIs masked: a stack draws its secret at random) and the free pages
   (the reference's forwarded pages stay held: F6, carried) identical,
   ``flash_attention`` launched once a layer a prefill and
   ``paged_attention`` once a layer a decode step by the kernel run only.

Float32 products of the plain versions run in full float32 (TF32 off).
Each phase prints one JSON line. Then come the card's name and power limit
(``nvidia-smi``), the ``{"kernels": [...]}`` line, and last ``{"ok": true,
"device": {...}}``. Any failure exits non-zero before the last line; with
no CUDA device, or outside a checkout, it fails at once.

``python3 chip_smoke.py --mlstm-ab [--serve] A.cu B.cu ...`` runs only the
mLSTM scan's checks for other versions of ``csrc/mlstm_scan.cu`` (an
earlier commit's, unpacked under ``build/``; stages of a rewrite): it
builds each source into its own library, runs phase 7 against each (and
phase 8 through each, with ``--serve``) and times each at the run's shape
as phase 9 does, in turns (A B ... B A, twice), in one process on one
card.

``python3 chip_smoke.py --flash-ab A.cu B.cu ...`` does the same for
versions of ``csrc/flash_attention.cu``: the ``flash_attention`` cases of
phase 5 against each build and phase 9's prefill-layer timing of each, in
turns. ``python3 chip_smoke.py --paged-ab A.cu B.cu ...`` does the same
for versions of ``csrc/paged_attention.cu``: the ``paged_attention`` cases
of phase 5 and phase 9's decode-layer timing, with the row's bytes bound,
each build's TB/s and its share of the bound. ``--gather-ab`` and
``--fused-ab`` do the same for ``csrc/selective_gather.cu`` and
``csrc/fused_round.cu``: the kernel's cases of phase 1 and the
deployment's timing under both flushes, beside a kernel that returns at
once (and, for the gather, ``index_select`` of its rows and a ``copy_`` of
as many bytes as it writes; the fused round at ring depths 0, 2, 3, 4 and
8; a ``fused_round.cu`` whose entry point has no depth argument runs every
depth alike). ``--copy-ab`` and ``--policy-ab`` do the same for
``csrc/selective_copy.cu`` and ``csrc/policy_match.cu``: the kernel's
cases of phase 1 and the deployment's timing, plain and with the
keystream, under both flushes, beside a kernel that returns at once (and
for the copy a ``copy_`` of as many bytes as it writes). A header next
to a source is found before the one in ``csrc/``, so an earlier commit's
sources can bring their own. The modes compile with ``-I
src/repro_torch/kernels/csrc``, so a copy under ``build/`` finds the
shared headers, and print each build's ``ptxas -v`` and
SASS opcode mix of its run-shape instantiation.

``python3 chip_smoke.py --linear`` runs only the prefill projections'
kernel (``csrc/linear_f32.cu``, no TPU kernel): the build's ``ptxas -v``
report, then at phi4-mini-3.8b's seven projection shapes with 4096 rows
its largest error from a float64 product beside ``torch.matmul``'s (it
must stay within 4x), and both medians under both flushes beside the
split-TF32 bound; hymba's ragged widths for the error only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
# 32-bit integer add, compare, min/max and logical ops issue at 64 results
# per clock per SM on compute capability 9.0 (CUDA C++ Programming Guide,
# "Throughput of Native Arithmetic Instructions"); the kernels' operations
# are of that type. The peak is this times the SM count times the card's
# maximum SM clock, both read from the card.
INT32_OPS_PER_SM_CLOCK = 64
# float32 FMA: 128 lanes per SM, 2 operations each, per clock (the same
# table); the attention kernels' operations are of that type.
FP32_OPS_PER_SM_CLOCK = 256
# TF32 on the tensor cores, dense: 1024 multiply-adds per SM per clock
# (H100 SXM: 494.7 TFLOP/s at the data sheet's 1830 MHz boost, 132 SMs).
# The flash attention and mLSTM kernels take each float32 product as three
# TF32 products (hi.hi + hi.lo + lo.hi), so their bound is three times the
# function's operations at this rate; the float32-FMA bound is printed
# beside it.
TF32_OPS_PER_SM_CLOCK = 2048
TF32_SPLIT_PASSES = 3
ATTN_TOL = dict(atol=1e-4, rtol=1e-4)
# the JAX package's bars for its Pallas mLSTM kernel (tests/test_kernels.py)
MLSTM_TOL = dict(atol=5e-4, rtol=5e-4)
MLSTM_TOL_EXTREME = dict(atol=3e-3, rtol=3e-3)
# xLSTM decode state after prefill: 24 blocks and 3 x 4096 sLSTM steps
# amplify the scans' float32 rounding, so the kernel run is held against a
# run whose scans are float64, no farther from it than this many times the
# plain float32 run is. Sound kernel runs read at most 1.17 (PERF.md,
# section 6); a run whose scans take bfloat16-rounded inputs must exceed it
XLSTM_STATE_FACTOR = 2.0
TIMED_RUNS = 30
SPIN_CYCLES = 1_000_000     # ~0.5 ms at H100 clocks: longer than an enqueue

KERNELS = {
    "selective_copy": "src/repro/kernels/selective_copy.py:94",
    "selective_gather": "src/repro/kernels/selective_copy.py:364",
    "policy_match": "src/repro/kernels/selective_copy.py:265",
    "fused_round": "src/repro/kernels/selective_copy.py:554",
    "paged_attention": "src/repro/kernels/paged_attention.py:84",
    "flash_attention": "src/repro/kernels/flash_attention.py:82",
    "mlstm_scan": "src/repro/kernels/mlstm_scan.py:73",
}
DATAPATH = ("selective_copy", "selective_gather", "policy_match",
            "fused_round")
# fused_round's ring depths held and timed: 0 is the wrapper's default
FUSED_DEPTHS = (0, 2, 3, 4)
# ring depths phase 11 profiles, any of which it may pick and run the
# main path at: each is held against the plain version in phase 1
PROFILE_DEPTHS = FUSED_DEPTHS + (8,)
# kernels each datapath run must launch, and kernels it must not: a fused
# round anchors and matches in its one launch, but sends its speculation
# missed (policy reroutes, drops, cross-worker grants) still gather in
# their own launch
LAUNCH_EXPECT = {"fused-round": (("fused_round",),
                                 ("selective_copy", "policy_match")),
                 "auto": (("selective_copy", "policy_match",
                           "selective_gather"), ("fused_round",)),
                 "host": ((), DATAPATH)}


@dataclasses.dataclass(frozen=True)
class Size:
    """The deployment the smoke run drives (see PERF.md, Cells)."""
    n_shards: int = 4
    pages_per_shard: int = 8192     # 32768 pages + scratch = 128 MiB int32
    page: int = 1024                # 4 KiB of int32 tokens
    channels: int = 64
    msgs: int = 16
    meta_tokens: int = 256          # the parser's 256-token lookahead
    payload_lo: int = 4096
    payload_hi: int = 16384

    @property
    def pool_rows(self) -> int:
        return self.n_shards * self.pages_per_shard + 1

    @property
    def pps(self) -> int:
        return self.payload_hi // self.page

    @property
    def meta_max(self) -> int:
        return self.meta_tokens

    def meta_app(self, tls) -> int:
        """Application metadata tokens per message: the whole metadata
        prefix (3 framing tokens, plus the 5-token record header under
        kTLS) is ``meta_tokens``, so it fits the parser's lookahead."""
        from repro_torch.core.crypto import REC_HEADER
        return self.meta_tokens - 3 - (REC_HEADER if tls else 0)


SMALL = dict(b=5, page=8, pps=3, meta_max=5)


@dataclasses.dataclass(frozen=True)
class ServeSize:
    """A serving run (see PERF.md, Cells); the defaults are phase 6's:
    phi4-mini-3.8b at full width and depth, the engine's default page
    size."""
    arch: str = "phi4-mini-3.8b"
    #: layers served; 0 keeps the config's depth
    layers: int = 0
    seed: int = 0
    requests: int = 16
    max_batch: int = 8
    prompt: int = 1024
    header: int = 8
    gen: int = 32
    page: int = 16
    #: decode context of the paged_attention timing: the middle of a wave
    timing_context: int = 1040

    @property
    def max_len(self) -> int:        # launch/serve.py: prompt + gen + 8
        return self.prompt + self.gen + 8

    @property
    def pps(self) -> int:            # LibraEngine: max_len // page + 2
        return self.max_len // self.page + 2

    @property
    def pool_pages(self) -> int:     # LibraEngine: max_batch * pps + 4
        return self.max_batch * self.pps + 4

    def config(self):
        """The arch's published config, its depth cut to ``layers``."""
        return cut_config(self.arch, self.layers)


def cut_config(arch: str, layers: int):
    """``arch``'s published config, its depth cut to ``layers`` (0 keeps
    it)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


#: phase 15: the moe family. qwen2-moe-a2.7b at full width and depth;
#: qwen3-moe-30b-a3b at full width, 12 of its 48 layers (the whole model
#: is 122 GB in float32, more than one card holds)
MOE_RUNS = (ServeSize(arch="qwen2-moe-a2.7b", requests=8, max_batch=8,
                      prompt=512, gen=16, timing_context=520),
            ServeSize(arch="qwen3-moe-30b-a3b", layers=12, requests=4,
                      max_batch=4, prompt=512, gen=8, timing_context=516))
#: phase 16: the dense configs left, at full width and depth
DENSE_RUNS = (ServeSize(arch="minicpm-2b", requests=4, max_batch=4,
                        prompt=256, gen=8, timing_context=260),
              ServeSize(arch="mistral-nemo-12b", requests=4, max_batch=4,
                        prompt=256, gen=8, timing_context=260))
#: phase 17: the hybrid family, hymba-1.5b at full width and depth; its
#: prompts are longer than its window (1024)
HYBRID_RUNS = (ServeSize(arch="hymba-1.5b", requests=8, max_batch=4,
                         prompt=1280, gen=16, timing_context=1288),)
#: phase 18: the vlm family, internvl2-76b at full width with 16 of its
#: 80 layers (the whole model is 282.5 GB in float32; 16 layers, the
#: embedding and the head are 63.4 GB). ``prompt`` counts every prefill
#: position: the image's 256 patch embeddings and 512 text tokens
VLM_RUN = ServeSize(arch="internvl2-76b", layers=16, requests=4, max_batch=4,
                    prompt=768, gen=8, timing_context=776)
#: phase 19: the encdec family, whisper-medium at full width and depth (24
#: encoder and 24 decoder layers): 1500 frames a request (the config's
#: ``enc_frames``, 30 s of audio) and a decoder prompt of 32 tokens
ENCDEC_RUN = ServeSize(arch="whisper-medium", requests=8, max_batch=8,
                       prompt=32, gen=32, timing_context=48)
#: how far the final ssm_state of phase 17's kernel run may lie from the
#: plain run's where no token diverged: the decode steps carry the
#: attention kernels' float32 rounding (split TF32) through 32 layers
SSM_STATE_TOL = dict(atol=1e-3, rtol=1e-3)
#: the router's top-k boundary margin (k-th against (k+1)-th probability)
#: below which the plain run's routing may flip under float32 rounding:
#: from the first step where it falls below, a differing token is excused
ROUTER_MARGIN = 1e-6


@dataclasses.dataclass(frozen=True)
class XlstmSize:
    """The xLSTM run (see PERF.md, Cells): xlstm-350m at full width and
    depth, 8 prompts of 4096 tokens, one prefill and 31 decode steps."""
    arch: str = "xlstm-350m"
    seed: int = 0
    batch: int = 8
    prompt: int = 4096
    gen: int = 32
    chunk: int = 64


class SmokeError(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# phase 1: parity
# ---------------------------------------------------------------------------

def max_abs(a, b) -> int:
    if a is None and b is None:
        return 0
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max().item())


def widen(case: dict, rows: int, rng, np):
    """Place a generated case's pool pages at random distinct rows of a
    deployment-sized pool (the last row stays the scratch row)."""
    tables = case["tables"]
    used = np.unique(tables[tables >= 0])
    dest = rng.choice(rows - 1, size=len(used), replace=False)
    remap = np.full(int(case["pool"].shape[0]), -1, np.int64)
    remap[used] = dest
    big = rng.integers(0, 5, (rows, case["pool"].shape[1]), dtype=np.int32)
    big[dest] = case["pool"][used]
    out = dict(case)
    out["pool"] = big
    out["tables"] = np.where(tables >= 0, remap[np.maximum(tables, 0)],
                             -1).astype(np.int32)
    return out


def selcopy_dict(t):
    keys = ("stream", "meta_len", "total_len", "pool", "tables", "keystream")
    return dict(zip(keys, t))


def run_pair(fn_kernel, fn_plain, pool_k, pool_r, torch):
    """Run a kernel and its plain version on copies of one pool; return
    (kernel outputs, plain outputs) as tuples, checking pool storage."""
    ptr = pool_k.data_ptr() if pool_k is not None else None
    out_k = fn_kernel(pool_k)
    out_r = fn_plain(pool_r)
    torch.cuda.synchronize()
    if pool_k is not None:
        check(pool_k.data_ptr() == ptr, "pool storage moved")
    return out_k, out_r


def parity(size: Size, dev, torch, np, ops, tt, kernels=DATAPATH):
    rng = np.random.default_rng(11)
    results = []

    def record(kernel, label, outs_k, outs_r):
        errs = [max_abs(a, b) for a, b in zip(outs_k, outs_r)]
        same = all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(outs_k, outs_r))
        results.append(dict(kernel=kernel, case=label, equal=same,
                            max_abs_err=max(errs)))
        check(same, f"{kernel} [{label}] differs from its plain version "
                    f"(max abs err {max(errs)})")

    big = dict(b=size.channels, page=size.page, pps=size.pps,
               meta_max=size.meta_max)
    # -- selective_copy: deployment, small ragged, edge rows; rows at the
    # edges of the kernel's 16-byte groups (meta_len % 4 in 0..3, S % 4 in
    # 0..3, payloads ending at S or cut by it, -1 slots between valid
    # ones) at the deployment's page in its pool, at a page of 6 tokens
    # (the word path) and of 2048 (two groups a thread) ----------------
    cases = [] if "selective_copy" not in kernels else [
        ("deploy", widen(selcopy_dict(tt.selcopy_crypto_case(rng, **big)),
                         size.pool_rows, rng, np), size.meta_max),
        ("small", selcopy_dict(tt.selcopy_crypto_case(rng, **SMALL)),
         SMALL["meta_max"]),
        ("edge", selcopy_dict(tt.edge_rows_case()), 8)] + [
        (f"group-edges/S%4={tail}", widen(selcopy_dict(tt.selcopy_edge_case(
            page=size.page, pps=size.pps, meta_max=size.meta_max,
            s_tail=tail)), size.pool_rows, rng, np), size.meta_max)
        for tail in range(4)] + [
        (f"odd-page/S%4={tail}", selcopy_dict(tt.selcopy_edge_case(
            page=6, pps=3, meta_max=8, s_tail=tail)), 8)
        for tail in (0, 1)] + [
        ("two-group-page", selcopy_dict(tt.selcopy_edge_case(
            page=2048, pps=2, meta_max=16)), 16)]
    for label, case, meta_max in cases:
        for crypto in (False, True):
            c = tt.to_torch(case, dev)
            ks = c["keystream"] if crypto else None

            def run(impl, pool):
                return ops.selective_copy(
                    c["stream"], c["meta_len"], c["total_len"], pool,
                    c["tables"], meta_max=meta_max, impl=impl, keystream=ks)
            pk, pr = c["pool"], c["pool"].clone()
            ok, orr = run_pair(lambda p: run("cuda", p),
                               lambda p: run("ref", p), pk, pr, torch)
            check(ok[1] is pk, "selective_copy returned another pool")
            record("selective_copy", f"{label}/{'ks' if crypto else 'plain'}",
                   ok, orr)
    # -- selective_gather: deployment, small, a page of 6 tokens (no
    # 16-byte row alignment: the 4-byte copy path), pages of two tiles ---
    gcases = [] if "selective_gather" not in kernels else [
        ("deploy", tt.selgather_case(
            rng, b=size.channels, page=size.page, pps=size.pps,
            p_total=size.pool_rows - 1)),
        ("small", tt.selgather_case(rng, b=SMALL["b"], page=SMALL["page"],
                                    pps=SMALL["pps"])),
        ("odd-page", tt.selgather_case(rng, b=5, page=6, pps=3)),
        ("two-tile-page", tt.selgather_case(rng, b=3, page=2048, pps=2))]
    for label, case in gcases:
        pool, tables, lengths, ks = tt.to_torch(case, dev)
        for crypto in (False, True):
            k = ks if crypto else None
            ok, orr = run_pair(
                lambda p: (ops.selective_gather(p, tables, lengths,
                                                impl="cuda", keystream=k),),
                lambda p: (ops.selective_gather(p, tables, lengths,
                                                impl="ref", keystream=k),),
                pool, pool, torch)
            record("selective_gather",
                   f"{label}/{'ks' if crypto else 'plain'}", ok, orr)
    # -- policy_match: the deployment table, a wide table, small; R x K =
    # 32 (one round of the lanes), R = 33 (two chunks of rules, the match
    # in the second), K = 33, payload positions past W and past
    # payload_len, an odd M (4-byte copies), and rows too wide to stage
    # in shared memory (the payload window, then the metadata) ----------
    pcases = [] if "policy_match" not in kernels else [
        ("deploy", tt.policy_payload_case(
            rng, b=size.channels, meta_max=size.meta_max, r=3, k=1,
            w=size.page), 3),
        ("wide", tt.policy_payload_case(rng, b=9, meta_max=40, r=70, k=40,
                                        w=16), 70),
        ("small", tt.policy_payload_case(rng, b=6, meta_max=12, r=7, k=3,
                                         w=8), 7),
        ("one-round", tt.policy_payload_case(rng, b=8, meta_max=16, r=8,
                                             k=4, w=8), 8),
        ("r33-k33", tt.policy_edge_case(rng, b=12, meta_max=24, r=33, k=33,
                                        w=16), 33),
        ("r33-last", tt.policy_edge_case(rng, b=12, meta_max=24, r=33, k=1,
                                         w=16, fail_first=32), 33),
        ("k33", tt.policy_edge_case(rng, b=12, meta_max=24, r=4, k=33,
                                    w=16), 4),
        ("payload-edges", tt.policy_edge_case(rng, b=10, meta_max=12, r=6,
                                              k=2, w=8), 6),
        ("odd-m", tt.policy_payload_case(rng, b=7, meta_max=13, r=7, k=3,
                                         w=9), 7),
        ("unstaged-window", tt.policy_payload_case(
            rng, b=9, meta_max=64, r=5, k=3, w=16384), 5),
        ("unstaged-meta", tt.policy_payload_case(rng, b=5, meta_max=3101,
                                                 r=5, k=3, w=8), 5)]
    # each of keystream, live and payload absent and present
    variants = {"plain": (), "ks": ("ks",), "live": ("live",),
                "payload": ("payload",), "ks+live": ("ks", "live"),
                "ks+payload": ("ks", "payload"),
                "live+payload": ("live", "payload"),
                "all": ("ks", "live", "payload")}
    for label, case, r in pcases:
        meta, ml, off, lo, hi, ks, pw, pln = case
        ml = ml.copy()
        ml[0] = 0                                   # an empty metadata row
        live = tt.policy_live_column(rng, r)
        t = tt.to_torch(dict(meta=meta, ml=ml, off=off, lo=lo, hi=hi, ks=ks,
                             pw=pw, pln=pln, live=live), dev)
        for vname, opts in variants.items():
            kw = dict(keystream=t["ks"] if "ks" in opts else None,
                      live=t["live"] if "live" in opts else None)
            if "payload" in opts:
                kw.update(payload=t["pw"], payload_len=t["pln"])
            ok, orr = run_pair(
                lambda _p: (ops.policy_match(t["meta"], t["ml"], t["off"],
                                             t["lo"], t["hi"], impl="cuda",
                                             **kw),),
                lambda _p: (ops.policy_match(t["meta"], t["ml"], t["off"],
                                             t["lo"], t["hi"], impl="ref",
                                             **kw),),
                None, None, torch)
            record("policy_match", f"{label}/{vname}", ok, orr)
    if pcases:
        t = tt.to_torch(dict(meta=pcases[2][1][0], ml=pcases[2][1][1],
                             none=np.zeros((0, 3), np.int32)), dev)
        ok, orr = run_pair(
            lambda _p: (ops.policy_match(t["meta"], t["ml"], t["none"],
                                         t["none"], t["none"], impl="cuda"),),
            lambda _p: (ops.policy_match(t["meta"], t["ml"], t["none"],
                                         t["none"], t["none"], impl="ref"),),
            None, None, torch)
        record("policy_match", "no-rules", ok, orr)
    # -- fused_round ---------------------------------------------------------
    operand_sets = {
        "none": (),
        "crypto": ("keystream", "tx_keystream"),
        "policy": ("cond_off", "cond_lo", "cond_hi"),
        "crypto+policy+live": ("keystream", "tx_keystream", "cond_off",
                               "cond_lo", "cond_hi", "live"),
        "all": ("keystream", "tx_keystream", "cond_off", "cond_lo",
                "cond_hi", "live", "meta_ks"),
    }
    # with a policy table and both keystreams: edge rows (meta_len 0, 5
    # and 8: a window off its 16-byte boundary), the same with S = 31 (the
    # 4-byte copy path), a 70 x 40 table past the shared-memory budget,
    # and pages of two tiles
    with_policy = {k: operand_sets[k] for k in ("crypto+policy+live", "all")}
    fcases = [] if "fused_round" not in kernels else [
        ("deploy", widen(tt.fused_round_case(rng, r=3, k=1, **big),
                         size.pool_rows, rng, np), size.meta_max,
         operand_sets),
        ("small", tt.fused_round_case(rng, r=6, k=3, **SMALL),
         SMALL["meta_max"], operand_sets),
        ("edge", tt.edge_fused_round_case(), 8, with_policy),
        ("edge-odd-s", tt.edge_fused_round_case(meta_max=7), 7, with_policy),
        ("wide-table", tt.fused_round_case(rng, b=9, page=16, pps=3,
                                           meta_max=40, r=70, k=40), 40,
         with_policy),
        ("two-tile-page", tt.fused_round_case(rng, b=3, page=2048, pps=2,
                                              meta_max=16), 16, with_policy)]
    for label, case, meta_max, sets in fcases:
        for oname, keys in sets.items():
            c = tt.to_torch(case, dev)
            kw = {k: c[k] for k in keys}

            def run(impl, pool, depth=0):
                return ops.fused_round(
                    c["stream"], c["meta_len"], c["total_len"], pool,
                    c["tables"], meta_max=meta_max, impl=impl,
                    n_buffers=depth, **kw)
            want = run("ref", c["pool"].clone())
            for depth in PROFILE_DEPTHS:    # bit-identical at every depth
                pk = c["pool"].clone()
                ok, orr = run_pair(lambda p: run("cuda", p, depth),
                                   lambda _p: want, pk, None, torch)
                check(ok[1] is pk, "fused_round returned another pool")
                record("fused_round", f"{label}/{oname}/n_buffers={depth}",
                       ok, orr)
    emit({"phase": "parity", "cases": len(results),
          "all_equal": all(r["equal"] for r in results),
          "max_abs_err": {k: max(r["max_abs_err"] for r in results
                                 if r["kernel"] == k) for k in kernels}})
    return results


# ---------------------------------------------------------------------------
# phases 2-3: end to end
# ---------------------------------------------------------------------------

def policy_table(tls, core):
    """The deployment's three rules: a metadata drop, a payload-prefix
    forward and a metadata forward."""
    from repro_torch.core.crypto import REC_HEADER
    from repro_torch.core.policy import payload_at

    off = (REC_HEADER if tls else 0) + 3
    return core.PolicyTable([
        core.rule(core.drop(), core.between(off, 196, 199)),
        core.rule(core.forward(1), payload_at(0, 1950, 2000)),
        core.rule(core.forward(0), core.between(off, 100, 199)),
    ])


def load_channel(size: Size, tls, src, rng, np, core) -> None:
    """Deliver one channel's ``size.msgs`` messages into ``src``."""
    frames = [core.build_message(
        rng.integers(100, 200, size.meta_app(tls)),
        rng.integers(1000, 2000,
                     int(rng.integers(size.payload_lo,
                                      size.payload_hi + 1))))
        for _ in range(size.msgs)]
    src.deliver(src.tls.seal_frames(frames, src.parser.inner) if tls
                else np.concatenate(frames))


def build_run(size: Size, impl: str, tls, dev, np, core):
    """The deployment's stack, policy table and loaded runtime."""
    stack = core.LibraStack(n_shards=size.n_shards,
                            pages_per_shard=size.pages_per_shard,
                            page_size=size.page, secret=b"chip-smoke",
                            device=dev)
    table = policy_table(tls, core)
    # batch_tile=0: each round is ONE recv/forward pass over every ready
    # channel (B = 64); the adaptive tile would split such page-heavy
    # rounds into tiles of a few messages
    rt = core.ProxyRuntime(stack, tick_every=32, policy=table, batched=True,
                           batch_impl=impl, batch_tile=0)
    rng = np.random.default_rng(2026)
    for i in range(size.channels):
        src = stack.socket("length-prefixed", tls=tls)
        dsts = [stack.socket("length-prefixed", tls=tls) for _ in range(2)]
        rt.channel(src, dsts, name=f"ch{i}")
        load_channel(size, tls, src, rng, np, core)
    return stack, rt, table


def same_wires(a, b, np) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def check_device_plane(tag: str, impl: str, xfers, counters, launches,
                       workers) -> None:
    """No fallback hides the card: no worker in ``workers`` synced its
    pool or gathered a batched round on the host; on a device path each
    ran device rounds and none fell back to the host; and the expected
    kernels (and no others) launched."""
    if impl != "host":
        check(counters["device_fallbacks"] == 0,
              f"{tag}: rounds fell back to the host")
    for i in workers:
        x = xfers[i]
        if impl != "host":
            check(x["device_rounds"] > 0, f"{tag}: worker {i} ran no "
                  "device round")
        check(x["pool_syncs"] == 0, f"{tag}: worker {i} synced its pool")
        check(x.get("host_gathers", 0) == 0,
              f"{tag}: worker {i} gathered {x.get('host_gathers')} "
              "batched rounds on the host")
    must, must_not = LAUNCH_EXPECT[impl]
    for k in must:
        check(launches[k] > 0, f"{tag}: kernel {k} was never launched")
    for k in must_not:
        check(launches[k] == 0, f"{tag}: kernel {k} launched "
              f"{launches[k]} times")


def e2e_run(size: Size, impl: str, tls, dev, torch, np, core, kern,
            fused_buffers: int = 0):
    stack, rt, table = build_run(size, impl, tls, dev, np, core)
    stack.pool.fused_buffers = fused_buffers
    # the one-time residency upload (128 MiB) is set-up, timed apart
    t0 = time.perf_counter()
    if impl != "host":
        stack.pool._ensure_device()
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    kern.reset_launches()
    t0 = time.perf_counter()
    rt.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    fused_depths = dict(kern.FUSED_DEPTHS)
    wires = [d.tls.open_wire(d.tx_wire()) if tls else d.tx_wire()
             for ch in rt.channels for d in ch.dsts]
    out = dict(impl=impl, rounds=rt.rounds, seconds=dt,
               resident_init_seconds=resident_s,
               rounds_per_s=rt.rounds / dt,
               msgs=rt.messages_forwarded(),
               msgs_per_s=rt.messages_forwarded() / dt,
               launches=launches, fused_depths=fused_depths,
               fused_buffers=stack.pool.fused_buffers,
               xfer=dict(stack.pool.xfer),
               counters=dataclasses.asdict(stack.counters),
               verdicts=table.summary())
    rt.shutdown()
    check(stack.alloc.free_pages == stack.alloc.total_pages,
          f"{impl}: pages leaked after shutdown")
    return out, wires


def e2e(size: Size, tls, dev, torch, np, core, kern):
    # device paths run twice, in turns (fused, auto, host, auto, fused), so
    # process warm-up and drift do not land on one path
    runs, wires = [], []
    for impl in ("fused-round", "auto", "host", "auto", "fused-round"):
        r, w = e2e_run(size, impl, tls, dev, torch, np, core, kern)
        runs.append(r)
        wires.append(w)
    base_i = next(i for i, r in enumerate(runs) if r["impl"] == "host")
    base = runs[base_i]
    check(base["msgs"] > 0, "nothing was forwarded")
    for r, w in zip(runs, wires):
        impl = r["impl"]
        tag = f"{tls or 'plaintext'}/{impl}"
        check(same_wires(w, wires[base_i], np),
              f"{tag}: wire bytes differ from the host run")
        check(r["counters"] == base["counters"],
              f"{tag}: CopyCounters differ from the host run")
        check(r["verdicts"] == base["verdicts"],
              f"{tag}: policy verdicts differ from the host run")
        check(r["msgs"] == base["msgs"], f"{tag}: message count differs")
        x = r["xfer"]
        check(x["donated_rounds"] == x["device_rounds"],
              f"{tag}: donated_rounds != device_rounds")
        check_device_plane(tag, impl, [x], r["counters"], r["launches"],
                           (0,))
    summary = {}
    for r in runs:
        row = summary.setdefault(r["impl"], {"rounds": r["rounds"],
                                             "launches": r["launches"],
                                             "xfer": r["xfer"]})
        for k in ("seconds", "resident_init_seconds", "rounds_per_s",
                  "msgs_per_s"):
            row.setdefault(k, []).append(r[k])
    emit({"phase": f"e2e_{tls or 'plaintext'}", "identical": True,
          "msgs": base["msgs"], "rule_hits": base["verdicts"]["rule_hits"],
          "order": [r["impl"] for r in runs], "runs": summary})
    return runs


# ---------------------------------------------------------------------------
# phase 14: the verifier on the card
# ---------------------------------------------------------------------------

#: the main path's runs the round audit holds to the counters
AUDIT_RUNS = (("fused-round", None), ("fused-round", "hw"), ("auto", None))
#: kernels each audited path must have launched
AUDIT_LAUNCHED = {"fused-round": ("fused_round",),
                  "auto": ("selective_copy", "policy_match",
                           "selective_gather")}


def audit(size: Size, dev, torch, np, core):
    """The port's verifier on phases 2 and 3's deployment: the five passes
    through ``python -m repro_torch.analysis``'s ``main`` (the kernel
    audit on the card), the kernel registry on the card with its negative
    control, ``kernel_audit.audit_rounds`` of three runs, and
    ``scripts/check_kernel_parity_torch.py``."""
    import contextlib
    import io

    from repro_torch.analysis import kernel_audit
    from repro_torch.analysis.__main__ import main as analysis

    out, secs = {}, {}
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = analysis([])
    check(rc == 0, f"audit: python -m repro_torch.analysis failed:\n"
          f"{text.getvalue()}")
    out["passes"] = [ln for ln in text.getvalue().splitlines()
                     if ln and not ln.startswith(" ")]
    secs["passes"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    findings, seen = kernel_audit.audit_calls(
        kernel_audit.registry_calls(dev), dev)
    check(not findings, "audit: kernel registry on the card: "
          + "; ".join(f.format() for f in findings))
    control = seen["selective_copy[cloned-pool]"]["rules"]
    check("KERN002" in control,
          f"audit: the negative control was not flagged KERN002: {control}")
    out["registry"] = {name: {k: s[k] for k in (
        "kernels", "boundary_elems", "peak_scratch_bytes", "widest_int64")}
        for name, s in seen.items()}
    out["negative_control_rules"] = control
    secs["registry"] = time.perf_counter() - t0

    out["rounds"] = {}
    for impl, tls in AUDIT_RUNS:
        t0 = time.perf_counter()
        stack, rt, _table = build_run(size, impl, tls, dev, np, core)
        stack.pool._ensure_device()
        torch.cuda.synchronize()
        r = kernel_audit.audit_rounds(rt)
        rt.shutdown()
        tag = f"{impl}/{tls or 'plaintext'}"
        check(stack.alloc.free_pages == stack.alloc.total_pages,
              f"audit {tag}: pages leaked after shutdown")
        check(not r["active"], f"audit {tag}: " + "; ".join(r["active"]))
        check(r["rounds"] > 0 and r["xfer_delta"]["pool_syncs"] == 0,
              f"audit {tag}: no rounds, or a pool sync: {r}")
        for k in AUDIT_LAUNCHED[impl]:
            check(r["kernel_events"][k] > 0,
                  f"audit {tag}: {k} never launched: {r['kernel_events']}")
        out["rounds"][tag] = r
        secs[tag] = time.perf_counter() - t0

    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "check_kernel_parity_torch",
        ROOT / "scripts" / "check_kernel_parity_torch.py")
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = gate.main([])
    check(rc == 0, f"audit: check_kernel_parity_torch failed:\n"
          f"{text.getvalue()}")
    out["kernel_parity"] = text.getvalue().splitlines()
    secs["kernel_parity"] = time.perf_counter() - t0
    emit({"phase": "audit", "seconds": secs, **out})
    return out


#: profiler labels of the round assembly, on the traced stack alone
ASSEMBLY_LABELS = {"recv_batch": "chip_smoke.recv_batch",
                   "forward_batch": "chip_smoke.forward_batch"}


def label_assembly(stack, host_s: dict, record_function) -> None:
    """Wrap this ``stack``'s ``recv_batch`` and ``forward_batch`` (on the
    instance, nowhere else) under :data:`ASSEMBLY_LABELS`, adding each
    call's host seconds to ``host_s``."""
    for name, label in ASSEMBLY_LABELS.items():
        inner = getattr(stack, name)

        def wrapped(*args, _inner=inner, _label=label, **kw):
            t0 = time.perf_counter()
            try:
                with record_function(_label):
                    return _inner(*args, **kw)
            finally:
                host_s[_label] += time.perf_counter() - t0

        setattr(stack, name, wrapped)


def assembly_split(events, host_s: dict, wall: float) -> dict:
    """Host seconds in ``recv_batch`` and ``forward_batch``, their share
    of the run's wall, and the device seconds of the kernels and copies
    launched under each (linked through ``FunctionEvent.kernels`` and
    ``cpu_parent``)."""
    device_s = dict.fromkeys(ASSEMBLY_LABELS.values(), 0.0)
    for e in events:
        if str(e.device_type).endswith("CUDA") or not e.kernels:
            continue
        ops, up = set(), e
        while up is not None:
            ops.add(up.name)
            up = up.cpu_parent
        for label in device_s:
            if label in ops:
                device_s[label] += sum(k.duration for k in e.kernels) / 1e6
    out = {name: {"host_s": host_s[label],
                  "wall_share": host_s[label] / wall,
                  "device_s": device_s[label]}
           for name, label in ASSEMBLY_LABELS.items()}
    rest = wall - sum(host_s.values())
    out["rest_of_run"] = {"host_s": rest, "wall_share": rest / wall}
    return out


def trace(size: Size, dev, torch, np, core):
    """Device busy share of one plaintext run per device path, from a
    ``torch.profiler`` trace (device time summed over every kernel and
    copy, over the run's host wall time), and the round assembly split
    out: the host seconds in the stack's ``recv_batch`` and
    ``forward_batch`` (wrapped on the instance under profiler labels),
    their share of the wall, and the device time launched under each."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    for impl in ("fused-round", "auto"):
        stack, rt, _table = build_run(size, impl, None, dev, np, core)
        stack.pool._ensure_device()
        host_s = dict.fromkeys(ASSEMBLY_LABELS.values(), 0.0)
        label_assembly(stack, host_s, record_function)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rt.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rt.shutdown()
        by_name = {}
        for e in prof.key_averages():
            # device-side events only (kernels, copies, memsets): the CPU
            # ops that launched them carry the same time again, and a
            # label's device-side span covers its kernels again
            if str(getattr(e, "device_type", "")).endswith("CUDA") and \
                    e.key not in host_s:
                by_name[e.key] = e.device_time_total
        device_us = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        split = assembly_split(prof.events(), host_s, wall)
        check(all(split[n]["host_s"] > 0 for n in ASSEMBLY_LABELS),
              f"trace/{impl}: a round-assembly label saw no call: {split}")
        out[impl] = {"wall_s": wall, "device_s": device_us / 1e6,
                     "device_busy_share": device_us / 1e6 / wall,
                     "rounds": rt.rounds,
                     "top_device_us": {k[:60]: v for k, v in top},
                     "assembly": split}
    emit({"phase": "trace", "runs": out})
    return out


# ---------------------------------------------------------------------------
# phase 10: the four-worker cluster
# ---------------------------------------------------------------------------

CLUSTER_WORKERS = 4
#: channels whose two destinations sit on the next worker: 25 % of 64
CROSS_CHANNELS = 16


def build_cluster(size: Size, impl: str, tls, dev, np, core,
                  fallback: bool = False):
    """The deployment as ``CLUSTER_WORKERS`` workers, each with its own
    128 MiB resident pool and a clone of the policy table. Channel i's
    source is on worker i % 4; its two destinations are on the next worker
    for the first ``CROSS_CHANNELS`` channels and on its own otherwise.
    ``fallback``: sources on workers 0 and 1, destinations on 2 and 3,
    whose pools sit above their watermark (every grant becomes a copy)."""
    w = CLUSTER_WORKERS
    cl = core.LibraCluster(w, n_shards=size.n_shards,
                           pages_per_shard=size.pages_per_shard,
                           page_size=size.page, secret=b"chip-smoke",
                           device=dev)
    if fallback:
        for dw in (2, 3):
            cl.workers[dw].high_watermark = 0.0
    crt = core.ClusterRuntime(cl, work_stealing=False,
                              policy=policy_table(tls, core), batched=True,
                              batch_impl=impl, batch_tile=0, tick_every=32)
    rng = np.random.default_rng(2026)
    dsts = []
    for i in range(size.channels):
        if fallback:
            sw, dw = i % 2, 2 + i % 2
        else:
            sw = i % w
            dw = (sw + 1) % w if i < CROSS_CHANNELS else sw
        src = cl.socket("length-prefixed", worker=sw, tls=tls)
        pair = [cl.socket("length-prefixed", worker=dw, tls=tls)
                for _ in range(2)]
        crt.channel(src, pair, name=f"ch{i}")
        dsts += pair
        load_channel(size, tls, src, rng, np, core)
    return cl, crt, dsts


def cluster_run(size: Size, impl: str, tls, executor: str, dev, torch, np,
                core, kern, fallback: bool = False):
    cl, crt, dsts = build_cluster(size, impl, tls, dev, np, core, fallback)
    # the one-time residency uploads (4 x 128 MiB) are set-up, timed apart
    t0 = time.perf_counter()
    if impl != "host":
        for w in cl.workers:
            w.pool._ensure_device()
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    kern.reset_launches()
    t0 = time.perf_counter()
    worker_s = None
    if executor == "threads":
        _msgs, worker_s = crt.run_parallel(threads=True)
    else:
        crt.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    wires = [d.tls.open_wire(d.tx_wire()) if tls else d.tx_wire()
             for d in dsts]
    agg = cl.counters_aggregate()
    worker_rounds = [rt.rounds for rt in crt.runtimes]
    rounds = crt.rounds if executor == "run" else max(worker_rounds)
    msgs = crt.messages_forwarded()
    out = dict(impl=impl, executor=executor, rounds=rounds,
               worker_rounds=worker_rounds, seconds=dt,
               resident_init_seconds=resident_s,
               rounds_per_s=rounds / dt, msgs=msgs, msgs_per_s=msgs / dt,
               worker_seconds=worker_s, launches=launches,
               xfer=[dict(w.pool.xfer) for w in cl.workers],
               counters=dataclasses.asdict(agg), snapshot=agg.snapshot(),
               verdicts=crt.policy_summary()["aggregate"],
               stats=dict(cl.stats))
    tag = f"cluster/{tls or 'plaintext'}/{impl}/{executor}"
    check_device_plane(tag, impl, out["xfer"], out["counters"], launches,
                       (0, 1) if fallback else range(CLUSTER_WORKERS))
    crt.shutdown()      # assert_no_leaks: every pool free, no grant pin
    return out, wires


def cluster_identity(size: Size, tls, runs, dev, torch, np, core, kern):
    """The ``runs`` ((impl, executor) pairs) of one TLS mode: identical
    wire bytes, counters and verdicts across them, and wire bytes and
    counters equal to a single-stack run of the same traffic."""
    single, single_wires = e2e_run(size, "host", tls, dev, torch, np, core,
                                   kern)
    single_snap = core.CopyCounters(**single["counters"]).snapshot()
    out, base_w = [], None
    for impl, executor in runs:
        r, w = cluster_run(size, impl, tls, executor, dev, torch, np, core,
                           kern)
        gc.collect()
        tag = f"cluster/{tls or 'plaintext'}/{impl}/{executor}"
        if out:
            base = out[0]
            check(same_wires(w, base_w, np), f"{tag}: wire bytes differ "
                  f"from {base['impl']}/{base['executor']}")
            for k in ("counters", "verdicts", "msgs", "stats"):
                check(r[k] == base[k], f"{tag}: {k} differ from "
                      f"{base['impl']}/{base['executor']}")
        else:
            base_w = w
        check(r["msgs"] > 0, f"{tag}: nothing was forwarded")
        check(r["stats"]["grants"] > 0, f"{tag}: no cross-worker grant")
        check(r["stats"]["copies"] == 0, f"{tag}: a grant fell back to a "
              "copy below the watermark")
        check(same_wires(w, single_wires, np),
              f"{tag}: wire bytes differ from the single-stack run")
        check(tuple(r["snapshot"]) == tuple(single_snap),
              f"{tag}: counters differ from the single-stack run")
        out.append(r)
    return out


def cluster_fallback(size: Size, dev, torch, np, core, kern):
    """Directed case (a): every flow crosses to a worker above its
    watermark, so each handoff is the one-copy fallback, which reads the
    owner's device-truth rows back out of its pool."""
    small = dataclasses.replace(size, channels=CROSS_CHANNELS)
    res = {}
    wires = {}
    for impl in ("fused-round", "host"):
        r, w = cluster_run(small, impl, None, "run", dev, torch, np, core,
                           kern, fallback=True)
        gc.collect()
        tag = f"cluster/fallback/{impl}"
        check(r["stats"]["copies"] > 0, f"{tag}: no one-copy fallback")
        check(r["stats"]["grants"] == 0, f"{tag}: a zero-copy grant was made")
        check(r["counters"]["cross_worker_copied"]
              == r["stats"]["copied_tokens"] > 0,
              f"{tag}: copied tokens not counted")
        res[impl], wires[impl] = r, w
    check(same_wires(wires["fused-round"], wires["host"], np),
          "cluster/fallback: wire bytes differ from the host run")
    for k in ("counters", "verdicts", "stats"):
        check(res["fused-round"][k] == res["host"][k],
              f"cluster/fallback: {k} differ from the host run")
    return res


def cluster_dead_owner(size: Size, dev, torch, np, core, kern):
    """Directed case (b): worker 0 takes a message in by a ``fused-round``
    round (its rows are then truth on the card), grants it to worker 1
    and is killed: the grant is copied out of the dying pool and still
    transmits, byte for byte."""
    cl = core.LibraCluster(2, n_shards=size.n_shards,
                           pages_per_shard=size.pages_per_shard,
                           page_size=size.page, secret=b"chip-smoke",
                           device=dev)
    w0, w1 = cl.workers
    crt = core.ClusterRuntime(cl)
    src = cl.socket(worker=0)
    dst = cl.socket(worker=1)
    rng = np.random.default_rng(7)
    payload = rng.integers(1000, 2000, size.payload_hi)
    src.deliver(core.build_message(rng.integers(100, 200,
                                                size.meta_app(None)),
                                   payload))
    kern.reset_launches()
    got = w0.recv_batch([src], impl="fused-round")
    torch.cuda.synchronize()
    launches = dict(kern.LAUNCHES)
    check(len(got) == 1 and launches["fused_round"] == 1,
          f"cluster/dead_owner: the fused round did not take the message "
          f"in ({launches})")
    (buf, _n), = got.values()
    dirty = len(w0.pool.dirty_rows())
    check(dirty > 0, "cluster/dead_owner: no row is truth on the card")
    vpi = next(iter(src.connection.anchored))
    granted = cl.grant_into(w1, vpi)
    check(granted is not None, "cluster/dead_owner: the grant failed")
    d2h = w0.pool.xfer["d2h_tokens"]
    info = crt.kill_worker(0)
    d2h = w0.pool.xfer["d2h_tokens"] - d2h
    out = buf.copy()
    out[-1] = core.VpiRegistry.to_token(granted)
    dst.send(out)
    wire = np.asarray(dst.tx_wire())
    check(np.array_equal(wire[-len(payload):], payload),
          "cluster/dead_owner: the copied-out payload differs")
    check(info["grants_copied_out"] == 1
          and cl.stats["dead_grants_copied"] == 1,
          f"cluster/dead_owner: {info}, {cl.stats}")
    check(w0.alloc.free_pages == w0.alloc.total_pages
          and w0.alloc.granted_out_pages == 0,
          "cluster/dead_owner: the dead pool is not fully free")
    check(d2h >= len(payload), f"cluster/dead_owner: {d2h} tokens came "
          "down, fewer than the payload")
    res = dict(payload_tokens=len(payload), dirty_rows=dirty,
               copy_out_d2h_tokens=d2h, info=info,
               dead_grants_copied=cl.stats["dead_grants_copied"],
               launches=launches)
    crt.shutdown()
    return res


def cluster_chaos(dev, torch, np, kern):
    """Directed case (c): the standard chaos scenario of
    ``scripts/check_failover_recovery_torch.py`` (reset at 25 %, kill at
    50 %, policy swap at 75 % of the fault-free run's rounds) as
    ``fused-round`` rounds on the card, under ``run()`` and under
    ``run_parallel(threads=True)`` in epochs of one round."""
    path = ROOT / "scripts" / "check_failover_recovery_torch.py"
    spec = importlib.util.spec_from_file_location("failover_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    size = dict(n_chans=9, n_msgs=12, payload=32)
    res = {}
    for threads in (False, True):
        kw = dict(size, device=dev, batch_impl="fused-round",
                  threads=threads)
        tag = f"cluster/chaos/{'threads' if threads else 'run'}"
        steady = mod.run_scenario(chaos=False, **kw)
        kern.reset_launches()
        chaos = mod.run_scenario(chaos=True, steady_rounds=steady["rounds"],
                                 **kw)
        torch.cuda.synchronize()
        launches = dict(kern.LAUNCHES)
        mod.check_identity(chaos, steady)
        mod.check_recovery(chaos, size["n_chans"], size["n_msgs"],
                           threads=threads)
        check_device_plane(tag, "fused-round", chaos["xfer"],
                           {"device_fallbacks":
                            sum(chaos["device_fallbacks"])},
                           launches, range(3))
        res["threads" if threads else "run"] = {
            "steady_rounds": steady["rounds"], "rounds": chaos["rounds"],
            "msgs": chaos["msgs"], "drops": chaos["drops"],
            "retries": chaos["retries"], "failovers": chaos["failovers"],
            "policy_failovers": chaos["policy_failovers"],
            "breaker": chaos["health"],
            "seconds": chaos["dt"], "steady_seconds": steady["dt"],
            "worker_seconds": chaos["worker_s"],
            "cluster_stats": chaos["cluster_stats"],
            "fault_hits": chaos["fault_summary"]["hits_by_kind"],
            "launches": launches}
        gc.collect()
    return res


def cluster(size: Size, dev, torch, np, core, kern):
    """Phase 10: the four-worker cluster on the card (see the module
    docstring)."""
    t0 = time.perf_counter()
    keep = ("rounds", "worker_rounds", "seconds", "resident_init_seconds",
            "rounds_per_s", "msgs", "msgs_per_s", "worker_seconds",
            "launches", "stats")
    runs = {}
    for tls, plan in ((None, (("fused-round", "run"), ("auto", "run"),
                              ("host", "run"), ("fused-round", "threads"),
                              ("host", "threads"))),
                      ("hw", (("fused-round", "run"), ("host", "run")))):
        got = cluster_identity(size, tls, plan, dev, torch, np, core, kern)
        runs[tls or "plaintext"] = {f"{r['impl']}/{r['executor']}":
                                    {k: r[k] for k in keep} for r in got}
        runs[tls or "plaintext"]["rule_hits"] = got[0]["verdicts"][
            "rule_hits"]
    fb = cluster_fallback(size, dev, torch, np, core, kern)
    dead = cluster_dead_owner(size, dev, torch, np, core, kern)
    chaos = cluster_chaos(dev, torch, np, kern)
    emit({"phase": "cluster", "workers": CLUSTER_WORKERS,
          "cross_channels": CROSS_CHANNELS, "identical": True, "runs": runs,
          "fallback": {k: {kk: v[kk] for kk in keep}
                       for k, v in fb.items()},
          "dead_owner": dead, "chaos": chaos,
          "seconds": time.perf_counter() - t0})
    return runs


# ---------------------------------------------------------------------------
# phases 5-6: attention parity and serving
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 11: the fused round's ring depth
# ---------------------------------------------------------------------------

#: rows of a round: the datapath cell's, and the N = 256 point of
#: benchmarks/bench_batched_datapath.py (its N in {8, 64, 256})
PROFILE_ROWS = {"cell": 64, "bench_n256": 256}
PROFILE_ITERS = 20
#: the depth the override pins
OVERRIDE_DEPTH = 4


def depth_profiles(size: Size, dev, dp, kern) -> dict:
    """``profile_fused_depths`` at each of :data:`PROFILE_ROWS` (page,
    pages a row and metadata as the deployment's), plaintext and with
    both keystreams: each depth's ring, best wall-clock round and best
    CUDA-event kernel time; ``dma_compute_profile`` at the picked depth;
    and ``auto_buffer_depth``'s pick from each sweep."""
    out = {}
    for label, b in PROFILE_ROWS.items():
        shape = dict(b=b, page=size.page, pps=size.pps,
                     meta_max=size.meta_max)
        row = dict(shape, tasks=b * (1 + size.pps * -(-size.page
                                                       // kern.TILE)))
        for variant, ks in (("plain", False), ("keystreams", True)):
            profs = dp.profile_fused_depths(
                depths=PROFILE_DEPTHS, iters=PROFILE_ITERS, warmup=3,
                impl="cuda", device=dev, keystreams=ks, **shape)
            pick = dp.auto_buffer_depth(profiles=profs)
            check(all(p.kernel_s is not None for p in profs.values()),
                  f"depth/{label}/{variant}: no kernel time")
            row[variant] = {
                "pick": pick,
                "depths": {d: {"ring_depth": p.ring_depth,
                               "round_us": p.round_s * 1e6,
                               "kernel_us": p.kernel_s * 1e6}
                           for d, p in profs.items()},
                "dma_compute": dp.dma_compute_profile(
                    iters=PROFILE_ITERS, warmup=3, n_buffers=pick,
                    impl="cuda", device=dev, keystreams=ks, **shape)}
        out[label] = row
    return out


def depth_runs(size: Size, tls, depths, dev, torch, np, core, kern):
    """The ``fused-round`` run of phase 2 (or 3) at each of ``depths``
    (``fused_buffers``), beside ``host``: wire bytes, counters and
    verdicts equal to ``host`` and to the default depth's run, ``xfer``
    equal to the default depth's, and every ``fused_round`` launch at the
    ring depth ``fused_buffers`` names."""
    from repro_torch.kernels.selective_copy import ring_depth

    host, host_w = e2e_run(size, "host", tls, dev, torch, np, core, kern)
    out = []
    base = base_w = None
    for fb in depths:
        r, w = e2e_run(size, "fused-round", tls, dev, torch, np, core, kern,
                       fused_buffers=fb)
        gc.collect()
        tag = f"depth/{tls or 'plaintext'}/fused_buffers={fb}"
        for ref, ref_w, what in ((host, host_w, "host"),
                                 (base, base_w, "the default depth")):
            if ref is None:
                continue
            check(same_wires(w, ref_w, np), f"{tag}: wire bytes differ "
                  f"from {what}")
            for k in ("counters", "verdicts", "msgs"):
                check(r[k] == ref[k], f"{tag}: {k} differ from {what}")
        if base is None:
            base, base_w = r, w
        check(r["xfer"] == base["xfer"], f"{tag}: xfer differs from the "
              "default depth's")
        check_device_plane(tag, "fused-round", [r["xfer"]], r["counters"],
                           r["launches"], (0,))
        n = r["launches"]["fused_round"]
        check(r["fused_depths"] == {ring_depth(fb): n},
              f"{tag}: launched at ring depths {r['fused_depths']}, "
              f"expected {n} at {ring_depth(fb)}")
        out.append({"fused_buffers": fb, "ring_depth": ring_depth(fb),
                    "rounds": r["rounds"], "seconds": r["seconds"],
                    "launches": r["launches"],
                    "fused_depths": r["fused_depths"]})
    return out


def depth(size: Size, dev, torch, np, core, kern):
    """Phase 11: profile the depths, then run the main path at the depth
    ``auto_buffer_depth`` picks at the N = 256 shape and at the depth the
    ``LIBRA_FUSED_BUFFERS`` override pins, against the default depth and
    ``host``."""
    from repro_torch.kernels import dma_profile as dp

    saved = os.environ.pop("LIBRA_FUSED_BUFFERS", None)
    try:
        profiles = depth_profiles(size, dev, dp, kern)
        pick = profiles["bench_n256"]["keystreams"]["pick"]
        os.environ["LIBRA_FUSED_BUFFERS"] = str(OVERRIDE_DEPTH)
        override = dp.auto_buffer_depth()
        check(override == OVERRIDE_DEPTH, f"LIBRA_FUSED_BUFFERS="
              f"{OVERRIDE_DEPTH}: auto_buffer_depth returned {override}")
        del os.environ["LIBRA_FUSED_BUFFERS"]
        runs = {tls or "plaintext": depth_runs(size, tls,
                                               (0, pick, override), dev,
                                               torch, np, core, kern)
                for tls in (None, "hw")}
    finally:
        os.environ.pop("LIBRA_FUSED_BUFFERS", None)
        if saved is not None:
            os.environ["LIBRA_FUSED_BUFFERS"] = saved
    emit({"phase": "depth", "identical": True, "card": card_line(torch),
          "iters": PROFILE_ITERS, "profiles": profiles, "pick": pick,
          "override": override, "runs": runs})
    return runs


# ---------------------------------------------------------------------------
# phase 13: the port's benches
# ---------------------------------------------------------------------------

#: the smoke benches phase 13 leaves to phase 10: their wall-clock gates
#: (threads >= 1.5x at W = 4, recovery >= 0.7x) depend on how the host
#: schedules threads, and phase 10 holds their paths on the card
BENCHES_LEFT_TO_PHASE_10 = ("cluster_proxy", "chaos_proxy")
#: kernels the benches' CUDA run must launch
BENCH_KERNELS = DATAPATH + ("paged_attention", "flash_attention")
#: the benches whose rows compare by name only: its depth pick is by
#: kernel time on the card and by wall time on the CPU (phase 11 holds it)
BENCHES_BY_NAME = ("dma_overlap",)
#: fields (or ``derived`` pairs) that carry a bench's identity checks
IDENTITY_FIELDS = ("counters_match", "counters_match_single_stack",
                   "identical", "plaintext_identical")


def bench_rows(path: Path) -> list:
    check(path.exists(), f"{path.name}: the bench wrote no artifact")
    with open(path) as f:
        rows = json.load(f)["rows"]
    check(rows, f"{path.name}: the bench wrote no rows")
    return rows


def check_bench_row(tag: str, row: dict) -> None:
    """No ERROR row, no identity field false, and a resident-pool row
    (``xfer`` counted, not the legacy host pool's ``host_sync`` series)
    with no pool sync, no host gather and no device fallback."""
    name = row["name"]
    check(name != "ERROR", f"{tag}: {row.get('error')}")
    pairs = dict(t.split("=", 1) for t in row.get("derived", "").split()
                 if "=" in t)
    for k in IDENTITY_FIELDS:
        for v in (row.get(k), pairs.get(k)):
            check(v in (None, True, "True"), f"{tag}/{name}: {k} is {v}")
    if "xfer_pool_syncs" in row and "host_sync" not in name:
        for k in ("xfer_pool_syncs", "xfer_host_gathers",
                  "device_fallbacks"):
            check(row.get(k, 0) == 0, f"{tag}/{name}: {k} = {row[k]}")


def benches(dev, torch, kern, kattn, kmlstm):
    """Phase 13: the port's smoke benches (``benchmarks_torch.run``'s
    ``SMOKE_BENCHES`` less :data:`BENCHES_LEFT_TO_PHASE_10`, a scope and
    not a caught failure) through its runner in this process, once on the
    card and once on the CPU (the plain versions), under
    ``LIBRA_BENCH_SMOKE=1`` (restored after), with artifacts in a
    temporary directory (never over ``results/bench_torch/``). Fails on an
    ``ERROR`` row, a bench with no rows, an identity field that is false,
    a pool sync, host gather or device fallback on a resident-pool row, a
    CUDA row that differs from its CPU row once ``common.untimed`` has
    dropped the wall clock's fields (``dma_overlap``'s by name only), a
    kernel of :data:`BENCH_KERNELS` the CUDA run did not launch, or a
    launch in the CPU run. Returns each kernel's launches in the CUDA
    run (``mlstm_scan``'s too: no bench drives xLSTM)."""
    import contextlib
    import io
    import tempfile

    from benchmarks_torch import common as bcommon
    from benchmarks_torch import run as brun

    chosen = [(n, m) for n, m in brun.SMOKE_BENCHES
              if n not in BENCHES_LEFT_TO_PHASE_10]
    saved = os.environ.get("LIBRA_BENCH_SMOKE")
    os.environ["LIBRA_BENCH_SMOKE"] = "1"
    rows, launches, seconds = {}, {}, {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for where in ("cuda", "cpu"):
                out = Path(tmp) / where
                for k in (kern, kattn, kmlstm):
                    k.reset_launches()
                t0 = time.perf_counter()
                # the benches' CSV lines stay out of this script's output
                with contextlib.redirect_stdout(io.StringIO()):
                    failed = brun.run(chosen, device=where,
                                      out_dir=str(out))
                torch.cuda.synchronize()
                seconds[where] = time.perf_counter() - t0
                launches[where] = {**kern.LAUNCHES, **kattn.LAUNCHES,
                                   **kmlstm.LAUNCHES}
                rows[where] = {n: bench_rows(out / f"BENCH_{n}.json")
                               for n, _m in chosen}
                for n, rs in rows[where].items():
                    for r in rs:
                        check_bench_row(f"benches/{where}/{n}", r)
                check(failed == 0, f"benches/{where}: {failed} bench(es) "
                      "raised")
    finally:
        if saved is None:
            os.environ.pop("LIBRA_BENCH_SMOKE", None)
        else:
            os.environ["LIBRA_BENCH_SMOKE"] = saved
    for n, _m in chosen:
        got, want = rows["cuda"][n], rows["cpu"][n]
        check([r["name"] for r in got] == [r["name"] for r in want],
              f"benches/{n}: the CUDA run's rows are not the CPU run's")
        if n in BENCHES_BY_NAME:
            continue
        for g, w in zip(got, want):
            check(bcommon.untimed(g) == bcommon.untimed(w),
                  f"benches/{n}/{g['name']}: {bcommon.untimed(g)} != "
                  f"{bcommon.untimed(w)}")
    for k in BENCH_KERNELS:
        check(launches["cuda"][k] > 0, f"benches: {k} never launched")
    check(not any(launches["cpu"].values()),
          f"benches: the CPU run launched {launches['cpu']}")
    emit({"phase": "benches", "identical": True,
          "benches": [n for n, _m in chosen],
          "left_to_phase_10": list(BENCHES_LEFT_TO_PHASE_10),
          "rows": {n: len(rs) for n, rs in rows["cuda"].items()},
          "seconds": seconds, "launches": launches["cuda"]})
    return launches["cuda"]


def paged_case(gen, dev, torch, *, b, hq, hkv, hd, page, pps, pool_pages,
               seq_lens, gaps=False):
    """(q, pool, tables, page_pos, seq_lens) for paged_attention: row i
    owns distinct pages covering ``seq_lens[i] + 1`` keys, in order;
    ``gaps`` turns every third slot into ``-1`` and adds, after a row's
    last page, a page whose keys all lie past its ``seq_len``."""
    q = torch.randn((b, hq, hd), generator=gen, device=dev)
    pool = torch.randn((pool_pages, page, 2, hkv, hd), generator=gen,
                       device=dev)
    tables = torch.full((b, pps), -1, dtype=torch.int32)
    page_pos = torch.full((b, pps), -(1 << 20), dtype=torch.int32)
    nxt = 0
    for i, sl in enumerate(seq_lens):
        n = sl // page + 1
        for j in range(n):
            tables[i, j] = nxt % pool_pages
            page_pos[i, j] = j * page
            nxt += 1
        if gaps:
            tables[i, 1:n:3] = -1
            if n < pps:
                tables[i, n] = nxt % pool_pages
                page_pos[i, n] = (sl // page + 2) * page
                nxt += 1
    return (q, pool, tables.to(dev), page_pos.to(dev),
            torch.tensor(seq_lens, dtype=torch.int32, device=dev))


def serve_paged_case(ss: ServeSize, cfg, gen, dev, torch):
    """The decode step of a full wave: q [max_batch, Hq, hd] over one
    layer's pool view at ``timing_context`` keys per row."""
    return paged_case(gen, dev, torch, b=ss.max_batch, hq=cfg.num_heads,
                      hkv=cfg.num_kv_heads, hd=cfg.head_dim, page=ss.page,
                      pps=ss.pps, pool_pages=ss.pool_pages,
                      seq_lens=[ss.timing_context] * ss.max_batch)


def paged_timing_case(ss: ServeSize, cfg, gen, dev, torch, window=0):
    """Inputs of one layer's decode attention of a full wave, its label,
    the function's operations and bytes: 4 hd multiply-add operations per
    (query head, valid key); q, the valid keys' K and V head rows, the
    table, positions and lengths read once, the partial (acc, m, l)
    written once. With ``window``, only the keys it keeps are valid."""
    pc = serve_paged_case(ss, cfg, gen, dev, torch)
    q, _pool, tables, page_pos, sl = pc
    pos = (page_pos[:, :, None].long()
           + torch.arange(ss.page, device=dev)[None, None, :])
    valid = (tables[:, :, None] >= 0) & (pos <= sl.long()[:, None, None])
    if window > 0:
        valid &= sl.long()[:, None, None] - pos < window
    keys = int(valid.sum())
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    reads = q.numel() + keys * 2 * hkv * hd + 2 * tables.numel() + sl.numel()
    writes = q.numel() + 2 * q.shape[0] * hq
    return (pc, f"{ss.arch} B={q.shape[0]} ctx={ss.timing_context}"
            + (f" window={window}" if window else ""),
            4 * hq * hd * keys, 4 * (reads + writes))


def flash_case(gen, dev, torch, *, b, hq, hkv, s, hd, skv=None):
    """q [b, hq, s, hd] and k, v [b, hkv, skv, hd] (``skv`` = ``s`` when
    not given)."""
    skv = s if skv is None else skv
    return (torch.randn((b, hq, s, hd), generator=gen, device=dev),
            torch.randn((b, hkv, skv, hd), generator=gen, device=dev),
            torch.randn((b, hkv, skv, hd), generator=gen, device=dev))


def encdec_flash_shapes(es: ServeSize, cfg) -> dict:
    """The non-causal ``flash_attention`` calls of phase 19's prefill,
    keys padded as ``attention.noncausal_attention`` pads them: the
    encoder's self-attention (``enc_frames`` over ``enc_frames`` + pad)
    and the decoder's cross-attention (the prompt over the same keys)."""
    from repro_torch.models.attention import blockwise_kv_pad

    f = cfg.enc_frames
    heads = dict(b=es.max_batch, hq=cfg.num_heads, hkv=cfg.num_kv_heads,
                 hd=cfg.head_dim)
    return {"encoder": dict(heads, s=f, skv=f + blockwise_kv_pad(f, f)),
            "cross": dict(heads, s=es.prompt,
                          skv=f + blockwise_kv_pad(es.prompt, f))}


ATTN_KERNELS = ("paged_attention", "flash_attention")


def attn_parity(ss: ServeSize, cfg, dev, torch, ops, kernels=ATTN_KERNELS,
                served=()):
    """The attention ``kernels`` against their plain versions on the
    card; also at the prefill and decode shapes of each ``(ServeSize,
    config)`` of ``served``, at each attention window its layers use."""
    from repro_torch.models.transformer import layer_windows

    served = [(s, c, w) for s, c in served
              for w in sorted(set(layer_windows(c)))]
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    results = []

    def record(kernel, label, outs_k, outs_r):
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_r))
        ok = all(torch.allclose(a, b, **ATTN_TOL)
                 for a, b in zip(outs_k, outs_r))
        results.append(dict(kernel=kernel, case=label, close=ok,
                            max_abs_err=err,
                            max_abs_ref=max(float(b.abs().max())
                                            for b in outs_r)))
        check(ok, f"{kernel} [{label}] differs from its plain version "
                  f"(max abs err {err})")

    full = dict(b=ss.max_batch, hq=cfg.num_heads, hkv=cfg.num_kv_heads,
                s=ss.prompt, hd=cfg.head_dim)
    flash = [("g1-hd64", dict(b=2, hq=4, hkv=4, s=256, hd=64), True, 0),
             ("g3-hd128-tail", dict(b=2, hq=6, hkv=2, s=200, hd=128), True,
              0),
             ("g3-hd64-window", dict(b=1, hq=6, hkv=2, s=300, hd=64), True,
              100),
             ("g1-hd128-noncausal", dict(b=1, hq=2, hkv=2, s=130, hd=128),
              False, 0),
             ("g2-hd16-tail", dict(b=2, hq=4, hkv=2, s=40, hd=16), True, 0),
             ("g3-hd96-tail", dict(b=1, hq=3, hkv=1, s=70, hd=96), True, 0),
             ("g3-hd96-window-tail", dict(b=2, hq=6, hkv=2, s=390, hd=96),
              True, 130),
             ("g4-hd32-noncausal-window", dict(b=1, hq=8, hkv=2, s=270,
                                               hd=32), False, 75),
             ("g8-hd128-tail", dict(b=1, hq=32, hkv=4, s=200, hd=128), True,
              0),
             ("h36-hd64-tail", dict(b=1, hq=36, hkv=36, s=130, hd=64), True,
              0),
             ("serve", full, True, 0),
             # non-causal with Sq != Skv, Skv no multiple of 64
             ("g2-hd64-noncausal-sq>skv", dict(b=2, hq=4, hkv=2, s=150,
                                               skv=70, hd=64), False, 0),
             ("g2-hd128-noncausal-sq<skv", dict(b=1, hq=6, hkv=3, s=37,
                                                skv=203, hd=128), False, 0),
             ("g1-hd32-noncausal-sq1", dict(b=3, hq=2, hkv=2, s=1, skv=33,
                                            hd=32), False, 0)]
    ecfg = ENCDEC_RUN.config()
    flash += [(f"serve/{ENCDEC_RUN.arch}-{name}", shape, False, 0)
              for name, shape in encdec_flash_shapes(ENCDEC_RUN,
                                                     ecfg).items()]
    flash += [(f"serve/{s.arch}" + (f"-window{w}" if w else ""),
               dict(b=s.max_batch, hq=c.num_heads, hkv=c.num_kv_heads,
                    s=s.prompt, hd=c.head_dim), True, w)
              for s, c, w in served]
    if "flash_attention" not in kernels:
        flash = []
    for label, shape, causal, window in flash:
        q, k, v = flash_case(gen, dev, torch, **shape)
        outs = [ops.flash_attention(q, k, v, causal=causal, window=window,
                                    impl=impl) for impl in ("cuda", "ref")]
        record("flash_attention", label, outs[:1], outs[1:])
    paged = [("g1-hd64", dict(b=4, hq=8, hkv=8, hd=64, page=16, pps=8,
                              pool_pages=40, seq_lens=[5, 60, 100, 127]),
              False, 0),
             ("g3-hd128-gaps-window", dict(b=3, hq=6, hkv=2, hd=128, page=16,
                                           pps=10, pool_pages=40,
                                           seq_lens=[33, 120, 0]), True, 40),
             ("g3-hd128-gaps", dict(b=3, hq=6, hkv=2, hd=128, page=16,
                                    pps=10, pool_pages=40,
                                    seq_lens=[33, 120, 0]), True, 0),
             ("g2-hd16", dict(b=2, hq=4, hkv=2, hd=16, page=8, pps=5,
                              pool_pages=12, seq_lens=[17, 30]), False, 0),
             ("g4-hd96-gaps", dict(b=3, hq=8, hkv=2, hd=96, page=16, pps=12,
                                   pool_pages=40, seq_lens=[100, 17, 150]),
              True, 0),
             ("g1-hd32-pps70", dict(b=2, hq=4, hkv=4, hd=32, page=16, pps=70,
                                    pool_pages=120,
                                    seq_lens=[1000, 555]), False, 0),
             ("g8-hd64-page32-gaps-window",
              dict(b=2, hq=16, hkv=2, hd=64, page=32, pps=10, pool_pages=24,
                   seq_lens=[200, 70]), True, 150),
             ("g12-hd16", dict(b=2, hq=12, hkv=1, hd=16, page=8, pps=9,
                               pool_pages=20, seq_lens=[40, 63]), False, 0),
             ("b1-ctx1040", dict(b=1, hq=cfg.num_heads, hkv=cfg.num_kv_heads,
                                 hd=cfg.head_dim, page=ss.page, pps=ss.pps,
                                 pool_pages=ss.pool_pages,
                                 seq_lens=[ss.timing_context]), False, 0)]
    if "paged_attention" in kernels:
        for label, shape, gaps, window in paged:
            case = paged_case(gen, dev, torch, gaps=gaps, **shape)
            outs = [ops.paged_attention(*case, window=window, impl=impl)
                    for impl in ("cuda", "ref")]
            record("paged_attention", label, outs[0], outs[1])
        for label, s, c, w in [("serve", ss, cfg, 0)] + [
                (f"serve/{s.arch}" + (f"-window{w}" if w else ""), s, c, w)
                for s, c, w in served]:
            case = serve_paged_case(s, c, gen, dev, torch)
            outs = [ops.paged_attention(*case, window=w, impl=impl)
                    for impl in ("cuda", "ref")]
            record("paged_attention", label, outs[0], outs[1])
    emit({"phase": "attn_parity", "cases": len(results),
          "all_close": all(r["close"] for r in results), "tol": ATTN_TOL,
          "max_abs_err": {k: max(r["max_abs_err"] for r in results
                                 if r["kernel"] == k)
                          for k in kernels},
          "by_case": {f'{r["kernel"]}/{r["case"]}': [r["max_abs_err"],
                                                      r["max_abs_ref"]]
                      for r in results}})
    return results


class LogitMargins:
    """Top-2 margin and spread (max - min) of every row of every logits
    call of one run and, for an engine run (:meth:`step`), which call and
    row produced each token."""

    def __init__(self, model):
        self.calls = []           # [(margins [rows], spreads [rows])]
        self.where = {}           # (rid, token index) -> (call, row)
        inner = model.logits

        def logits(params, hidden, **kw):
            out = inner(params, hidden, **kw)
            top = out.topk(2, dim=-1).values
            self.calls.append(((top[:, 0] - top[:, 1]).tolist(),
                               (out.amax(-1) - out.amin(-1)).tolist()))
            return out
        model.logits = logits

    def step(self, eng, reqs):
        """``eng.step()``, noting where each new token came from: the
        prefill call (rows in admission order), then the decode call (rows
        are slots)."""
        waiting = list(eng.waiting)
        lens = {r.rid: len(r.output) for r in reqs}
        first = len(self.calls)
        eng.step()
        still = {r.rid for r in eng.waiting}
        admitted = [r.rid for r in waiting if r.rid not in still]
        for row, rid in enumerate(admitted):
            self.where[(rid, 0)] = (first, row)
        decode = first + (1 if admitted else 0)
        if len(self.calls) > decode:
            for r in reqs:
                had = lens[r.rid] + (1 if r.rid in admitted else 0)
                if len(r.output) > had:
                    self.where[(r.rid, had)] = (decode, r.slot)

    def margin(self, rid, index):
        call, row = self.where[(rid, index)]
        margins, spreads = self.calls[call]
        return margins[row], spreads[row]


def serve_run(ss: ServeSize, model, params, prompts, dev, torch, kattn,
              margins=None, watch=None):
    """One engine run over ``prompts``; returns (engine, results).
    ``watch`` (a :class:`RouterWatch`) is told where each step ends."""
    from repro_torch.core.parser import TokenStreamParser
    from repro_torch.serving.engine import LibraEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = LibraEngine(model, params, max_batch=ss.max_batch,
                      max_len=ss.max_len, page_size=ss.page,
                      parser=TokenStreamParser(header_len=ss.header),
                      device=dev)
    check(eng.pool.alloc.total_pages == ss.pool_pages and eng.pps == ss.pps,
          "engine geometry differs from the serve size")
    reqs = [eng.submit(p, max_new_tokens=ss.gen) for p in prompts]
    kattn.reset_launches()
    step_s = {"prefill": [], "decode": []}   # a step ends on a token download
    t0 = time.perf_counter()
    while eng.waiting or eng.active:
        prefills = eng.stats.prefills
        ts = time.perf_counter()
        if margins is None:
            eng.step()
        else:
            margins.step(eng, reqs)
        step_s["prefill" if eng.stats.prefills > prefills else "decode"
               ].append(time.perf_counter() - ts)
        if watch is not None:
            watch.mark(margins)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kattn.LAUNCHES)
    alloc = eng.pool.alloc
    check(alloc.free_pages == alloc.total_pages - 1 and
          len(eng.pool.registry) == 0,
          f"{model.attn_impl}: pages leaked ({alloc.free_pages} of "
          f"{alloc.total_pages} free, the parking page held)")
    out = run_summary(eng, reqs, dt, step_s, launches, torch)
    out["counters"] = dataclasses.asdict(eng.stack.counters)
    return eng, out


def run_summary(eng, reqs, dt, step_s, launches, torch) -> dict:
    """What a serving run prints: tokens/s, p99, time to first token, peak
    device memory, step times, launches, ``EngineStats`` and outputs."""
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    return dict(attn_impl=eng.model.attn_impl, seconds=dt,
                tokens=eng.throughput_tokens(),
                tokens_per_s=eng.throughput_tokens() / dt,
                p99_latency_ms=eng.p99_latency() * 1e3,
                ttft_s={"first": ttft[0], "median": statistics.median(ttft),
                        "last": ttft[-1]},
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                prefill_step_s=step_s["prefill"],
                decode_step_ms={k: f(step_s["decode"]) * 1e3 for k, f in (
                    ("min", min), ("median", statistics.median),
                    ("max", max))},
                launches=launches, steps=eng.stats.steps,
                stats=dataclasses.asdict(eng.stats),
                outputs={r.rid: list(r.output) for r in reqs})


def near_tie_diverged(ss: ServeSize, got: dict, want: dict, margins,
                      label: str, routing=None) -> list:
    """The first token where each request of ``got`` leaves ``want``;
    fails unless the plain Libra run's top-2 logit margin there is below
    1e-3 of the logits' spread (a float32 near-tie) or, for a moe run,
    ``routing`` (a :class:`RouterWatch` of the plain run) excuses it: the
    token came from the step at which the plain run's router first had a
    top-k boundary margin below ``ROUTER_MARGIN``, or a later one."""
    diverged = []
    flip = routing.first_low_margin() if routing is not None else None
    for rid, w in want.items():
        g = got[rid]
        check(len(g) == len(w) == ss.gen,
              f"{label}: request {rid}: wrong length")
        first = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                     None)
        if first is None:
            continue
        m, spread = margins.margin(rid, first)
        case = dict(rid=rid, token=first, margin=m, spread=spread)
        diverged.append(case)
        if m < 1e-3 * spread:
            case["excused_by"] = "logit near-tie"
            continue
        call, _row = margins.where[(rid, first)]
        check(flip is not None and call >= flip["logits_call"],
              f"{label}: request {rid} token {first}: {g[first]} vs "
              f"{w[first]}, plain top-2 margin {m} is not below 1e-3 of "
              f"the spread {spread}"
              + ("" if routing is None else
                 f", and no router margin below {ROUTER_MARGIN} came at or "
                 f"before its step (first: {flip})"))
        case.update(excused_by="router margin", router_step=flip["step"],
                    router_margin=flip["margin"])
    return diverged


def decode_split(eng, prompts, ss: ServeSize, torch):
    """Profiler split of one decode step of a full batch: device time of
    matmuls, the attention kernel, the KV write and everything else, and
    the host gaps (wall minus device time; one stream, no overlap)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.kernel_audit import WINDOW_PAUSE_S

    for p in prompts[:ss.max_batch]:
        eng.submit(p, max_new_tokens=3)
    eng.step()                                 # prefill + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_PAUSE_S)             # see standard_split
        t0 = time.perf_counter()
        eng.step()                             # a decode step, nothing else
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    kinds = {"attention": re.compile(r"paged_attention"),
             "matmul": re.compile(r"gemm|gemv|xmma|cutlass|splitK|dot_kernel",
                                  re.I),
             "kv_write": re.compile(r"index_put"),
             "copies": re.compile(r"memcpy|memset", re.I)}
    split = {k: 0.0 for k in (*kinds, "other")}
    top = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = e.device_time_total
        kind = next((k for k, rx in kinds.items() if rx.search(e.key)),
                    "other")
        split[kind] += us / 1e3
        top[e.key[:70]] = us / 1e3
    device_ms = sum(split.values())
    check(split["attention"] > 0, "the profiled step ran no paged_attention")
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "host_gap_ms": wall * 1e3 - device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "device_ms_by_kind": split,
            "top_device_ms": dict(sorted(top.items(),
                                         key=lambda kv: -kv[1])[:10])}


def serve(ss: ServeSize, dev, torch, np, kattn) -> dict:
    """phi4-mini-3.8b under LibraEngine, kernels against plain versions.
    Returns the model, parameters, prompts and margins phase 12 reuses,
    and the kernel run (``libra``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(ss.arch)
    models = {impl: build_model(cfg, page_size=ss.page, attn_impl=impl)
              for impl in ("auto", "ref")}
    t0 = time.perf_counter()
    params = models["auto"].init_params(ss.seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(ss.seed)
    prompts = [rng.integers(1, cfg.vocab_size - 1, ss.prompt)
               for _ in range(ss.requests)]
    margins = LogitMargins(models["ref"])
    eng, kern_run = serve_run(ss, models["auto"], params, prompts, dev,
                              torch, kattn)
    split = decode_split(eng, prompts, ss, torch)
    del eng
    _eng, ref_run = serve_run(ss, models["ref"], params, prompts, dev, torch,
                              kattn, margins)
    del _eng
    check(kern_run["stats"] == ref_run["stats"],
          "EngineStats differ between the kernel and plain runs")
    check(kern_run["counters"] == ref_run["counters"],
          "CopyCounters differ between the kernel and plain runs")
    diverged = near_tie_diverged(ss, kern_run["outputs"], ref_run["outputs"],
                                 margins, "kernel vs plain")
    for name in kattn.LAUNCHES:
        check(kern_run["launches"][name] > 0,
              f"{name} never launched in the serve run")
        check(ref_run["launches"][name] == 0,
              f"{name} launched in the plain run")
    keep = ("seconds", "tokens", "tokens_per_s", "p99_latency_ms", "ttft_s",
            "peak_mem_gb", "prefill_step_s", "decode_step_ms",
            "launches", "steps")
    emit({"phase": "serve", "arch": ss.arch, "params": cfg.param_count(),
          "param_init_s": init_s, "requests": ss.requests,
          "prompt": ss.prompt, "gen": ss.gen, "max_batch": ss.max_batch,
          "page": ss.page, "pool_pages": ss.pool_pages,
          "identical_tokens": not diverged, "diverged": diverged,
          "stats": kern_run["stats"], "counters": kern_run["counters"],
          "kernels": {k: kern_run[k] for k in keep},
          "plain": {k: ref_run[k] for k in keep},
          "decode_step_split": split})
    # phase 12 serves the same prompts on these parameters
    return dict(model=models["auto"], params=params, prompts=prompts,
                margins=margins, libra=kern_run)


# ---------------------------------------------------------------------------
# phase 12: the baseline engines
# ---------------------------------------------------------------------------

BASELINES = ("standard", "copier", "static")
#: ``record_function`` label of the dense attention in the Standard split
DENSE_ATTN_LABEL = "chip_smoke.dense_attention"


def baseline_run(ss: ServeSize, name: str, model, params, prompts,
                 memory_budget: int, dev, torch, kattn):
    """One run of the baseline engine ``name`` over ``prompts``; returns
    (engine, results): phase 6's summary, the active requests of each
    decode step and whether each step left the cache's storage in place."""
    from repro_torch.core.parser import TokenStreamParser
    from repro_torch.serving import engine as serving

    cls = {"standard": serving.StandardEngine,
           "copier": serving.CopierEngine,
           "static": serving.StaticEngine}[name]
    kw = (dict(memory_budget=memory_budget) if name == "static"
          else dict(max_batch=ss.max_batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = cls(model, params, max_len=ss.max_len,
              parser=TokenStreamParser(header_len=ss.header), device=dev,
              **kw)
    check(eng.max_batch == ss.max_batch,
          f"{name}: {eng.max_batch} slots, not {ss.max_batch}")
    reqs = [eng.submit(p, max_new_tokens=ss.gen) for p in prompts]
    kattn.reset_launches()
    step_s = {"prefill": [], "decode": []}   # a step ends on a download
    active, same_storage = [], []
    t0 = time.perf_counter()
    while eng.waiting or eng.active:
        prefills, steps = eng.stats.prefills, eng.stats.steps
        waiting, made = len(eng.waiting), sum(len(r.output) for r in reqs)
        ptr = eng.cache.data_ptr()
        ts = time.perf_counter()
        eng.step()
        step_s["prefill" if eng.stats.prefills > prefills else "decode"
               ].append(time.perf_counter() - ts)
        if eng.stats.steps > steps:       # the step decoded: its tokens,
            admitted = waiting - len(eng.waiting)   # less the prefill's
            active.append(sum(len(r.output) for r in reqs) - made - admitted)
            same_storage.append(eng.cache.data_ptr() == ptr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(sorted(eng.slot_free) == list(range(eng.max_batch)),
          f"{name}: slots leaked ({eng.slot_free})")
    out = run_summary(eng, reqs, dt, step_s, dict(kattn.LAUNCHES), torch)
    out.update(active_per_step=active, same_storage=same_storage,
               cache_bytes=eng.cache.numel() * 4)
    return eng, out


def standard_split(eng, prompts, ss: ServeSize, torch):
    """Profiler split of one full-batch StandardEngine decode step: device
    time of the cache copy (the step's device-to-device copy), the dense
    attention (kernels launched under a label around it) and the other
    matmuls (by the op that launched each kernel), the host transfers,
    the rest; and the host gaps (wall minus device time; one stream, no
    overlap). Device activity at the very start of a profiler window can be
    dropped, a warm-up step before it notwithstanding: the window
    (``kernel_audit.profile_window``) opens on a pause and then a marker
    kernel under its own label, which must be seen, before the step."""
    import re

    from torch.profiler import record_function

    from repro_torch.analysis.kernel_audit import (WINDOW_MARKER_LABEL,
                                                   profile_window)
    from repro_torch.models import attention as mattn

    for p in prompts[:ss.max_batch]:
        eng.submit(p, max_new_tokens=4)
    eng.step()                                 # prefill + first decode
    torch.cuda.synchronize()
    inner = mattn.dense_attention

    def labelled(*args, **kw):
        with record_function(DENSE_ATTN_LABEL):
            return inner(*args, **kw)

    def decode_step():                         # a decode step, nothing else
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    mattn.dense_attention = labelled
    try:                                       # warm-up: a decode step
        prof, wall = profile_window(decode_step, device=eng.cache.device,
                                    warmup=eng.step)
    finally:
        mattn.dense_attention = inner
    eng.run()
    events = list(prof.events())
    # every device activity, by name
    by_name = {"cache_copy": "Memcpy DtoD", "d2h": "Memcpy DtoH",
               "h2d": "Memcpy HtoD"}
    split = dict.fromkeys((*by_name, "dense_attention", "matmul", "other"),
                          0.0)
    device_ms, top = 0.0, {}
    for e in events:
        if not str(e.device_type).endswith("CUDA") or \
                getattr(e, "is_user_annotation", False) or \
                e.name in (DENSE_ATTN_LABEL, WINDOW_MARKER_LABEL):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        device_ms += ms
        top[e.name[:70]] = top.get(e.name[:70], 0.0) + ms
        for kind, prefix in by_name.items():
            if e.name.startswith(prefix):
                split[kind] += ms
    # kernels by the CPU op that launched them
    matmul = re.compile(r"gemm|gemv|xmma|cutlass|splitK|dot_kernel", re.I)
    linked_ms, marker_ms = 0.0, None
    for e in events:
        if str(e.device_type).endswith("CUDA") or not e.kernels:
            continue
        ops, up = set(), e
        while up is not None:
            ops.add(up.name)
            up = up.cpu_parent
        for k in e.kernels:
            if WINDOW_MARKER_LABEL in ops:
                marker_ms = (marker_ms or 0.0) + k.duration / 1e3
                continue
            linked_ms += k.duration / 1e3
            if DENSE_ATTN_LABEL in ops:
                split["dense_attention"] += k.duration / 1e3
            elif matmul.search(k.name):
                split["matmul"] += k.duration / 1e3
    check(marker_ms is not None,
          "the profiler's window lost its marker kernel: the split cannot be "
          "trusted to hold the whole step")
    device_ms -= marker_ms
    split["other"] = device_ms - sum(split.values())
    out = {"wall_ms": wall * 1e3, "device_ms": device_ms,
           "linked_device_ms": linked_ms,
           "host_gap_ms": wall * 1e3 - device_ms,
           "device_busy_share": device_ms / (wall * 1e3),
           "device_ms_by_kind": split,
           "top_device_ms": dict(sorted(top.items(),
                                        key=lambda kv: -kv[1])[:10])}
    for kind in ("cache_copy", "dense_attention", "d2h"):
        check(split[kind] > 0,
              f"the profiled Standard step shows no {kind}: {out}")
    return out


def baselines(ss: ServeSize, state: dict, dev, torch, np, kattn):
    """The Standard, Copier and Static engines on phase 6's parameters and
    prompts: tokens against the Libra kernel run under the near-tie rule,
    the stats' relations, the per-step copy (or its absence) in the
    cache's storage, and the launches of the prefill's flash attention."""
    model, params, prompts = state["model"], state["params"], state["prompts"]
    libra = state["libra"]
    cfg = model.cfg
    per_slot = (cfg.num_layers * ss.max_len * 2 * cfg.num_kv_heads
                * cfg.head_dim * 4)
    budget = int(np.prod(model.kv_pool_shape(ss.pool_pages))) * 4
    waves = -(-ss.requests // ss.max_batch)
    runs, diverged, split = {}, {}, None
    for name in BASELINES:
        eng, run = baseline_run(ss, name, model, params, prompts, budget,
                                dev, torch, kattn)
        if name == "standard":
            split = standard_split(eng, prompts, ss, torch)
        del eng
        runs[name] = run
        diverged[name] = near_tie_diverged(ss, run["outputs"],
                                           libra["outputs"], state["margins"],
                                           f"{name} vs libra")
        st = run["stats"]
        check(st["prefills"] == waves and
              run["launches"]["flash_attention"] == cfg.num_layers * waves,
              f"{name}: {run['launches']['flash_attention']} flash_attention "
              f"launches in {st['prefills']} prefills, not "
              f"{cfg.num_layers} x {waves}")
        check(run["launches"]["paged_attention"] == 0,
              f"{name}: paged_attention launched")
        prefill_kv = ss.requests * per_slot
        copies = 0 if name == "static" else st["steps"] * run["cache_bytes"]
        check(st["payload_copy_bytes"] == copies + prefill_kv,
              f"{name}: payload_copy_bytes {st['payload_copy_bytes']}, not "
              f"{copies} + {prefill_kv}")
        if name == "static":
            check(all(run["same_storage"]),
                  "static: a donated step moved the cache")
        else:
            check(not any(run["same_storage"]),
                  f"{name}: a step left the cache in place (no copy)")
    std, cop = runs["standard"]["stats"], runs["copier"]["stats"]
    for key in ("payload_copy_bytes", "steps", "prefills", "h2d_bytes"):
        check(std[key] == cop[key],
              f"standard and copier differ in {key}: {std[key]} {cop[key]}")
    check(cop["d2h_calls"] == cop["steps"],
          f"copier: {cop['d2h_calls']} downloads in {cop['steps']} steps")
    check(std["d2h_calls"] == sum(runs["standard"]["active_per_step"]),
          f"standard: {std['d2h_calls']} downloads, not one per active "
          "request a step")
    check(libra["stats"]["payload_copy_bytes"] == 0,
          "libra: payload copied")
    keep = ("seconds", "tokens", "tokens_per_s", "p99_latency_ms", "ttft_s",
            "peak_mem_gb", "prefill_step_s", "decode_step_ms", "launches",
            "steps", "stats")
    emit({"phase": "baselines", "arch": ss.arch, "requests": ss.requests,
          "max_batch": ss.max_batch, "max_len": ss.max_len,
          "static_memory_budget": budget, "cache_bytes_per_slot": per_slot,
          "diverged": diverged,
          "engines": {n: {k: r[k] for k in keep} for n, r in runs.items()},
          "libra": {k: libra[k] for k in keep},
          "standard_decode_step_split": split})
    return runs

# ---------------------------------------------------------------------------
# phases 15-16: the moe family, and the dense configs left
# ---------------------------------------------------------------------------

class RouterWatch:
    """What the MoE layers of one engine run do, kept on the card until
    the run ends: the entries each ``moe.dispatch_plan`` call drops past
    an expert's capacity and, with ``margins``, each router call's least
    top-k boundary margin over its rows (the k-th against the (k+1)-th
    probability). :meth:`mark` notes where each engine step ends."""

    def __init__(self, margins: bool):
        self.with_margins = margins
        self.drops, self.margins = [], []
        self.ends = []     # per step: (router calls, drop calls, logits calls)
        self._saved = None

    def __enter__(self):
        from repro_torch.models import moe

        router, plan = moe.router_topk, moe.dispatch_plan
        self._saved = (moe, router, plan)

        def router_topk(logits, cfg):
            if self.with_margins:
                probs = logits.float().clone()
                probs[:, cfg.num_experts:] = -1e30     # as router_topk masks
                top = probs.softmax(-1).topk(cfg.top_k + 1, dim=-1).values
                self.margins.append((top[:, -2] - top[:, -1]).min())
            return router(logits, cfg)

        def dispatch_plan(ids, cfg, cap, e_first, e_count):
            out = plan(ids, cfg, cap, e_first, e_count)
            self.drops.append((~out.kept).sum())
            return out

        moe.router_topk, moe.dispatch_plan = router_topk, dispatch_plan
        return self

    def __exit__(self, *exc):
        moe, router, plan = self._saved
        moe.router_topk, moe.dispatch_plan = router, plan
        self.drops = [int(d) for d in self.drops]         # the run is over
        self.margins = [float(m) for m in self.margins]

    def mark(self, logit_margins) -> None:
        self.ends.append((len(self.margins), len(self.drops),
                          len(logit_margins.calls) if logit_margins else 0))

    def _per_step(self, values, col, reduce):
        out, start = [], 0
        for end in self.ends:
            out.append(reduce(values[start:end[col]]) if end[col] > start
                       else None)
            start = end[col]
        return out

    def drops_by_step(self) -> list:
        return self._per_step(self.drops, 1, sum)

    def margin_by_step(self) -> list:
        return self._per_step(self.margins, 0, min)

    def first_low_margin(self):
        """The first router call whose least margin is below
        ``ROUTER_MARGIN`` (one call a MoE layer, in order): its index, its
        step, its place in the step, the margin, and the step's first
        logits call."""
        call = next((i for i, m in enumerate(self.margins)
                     if m < ROUTER_MARGIN), None)
        if call is None:
            return None
        step = next(i for i, end in enumerate(self.ends) if end[0] > call)
        start = self.ends[step - 1] if step else (0, 0, 0)
        return dict(call=call, step=step, call_in_step=call - start[0],
                    margin=self.margins[call], logits_call=start[2])


#: profiler labels of a decode step's parts, innermost first (a device
#: event goes to the first label whose host range holds its launch):
#: (label, module, function)
SPLIT_PARTS = (("moe.router", "repro_torch.models.moe", "router_topk"),
               ("moe.dispatch", "repro_torch.models.moe", "dispatch_plan"),
               ("moe.dispatch", "repro_torch.models.moe", "dispatch"),
               ("moe.experts", "repro_torch.models.moe", "expert_ffn"),
               ("moe.combine", "repro_torch.models.moe", "combine"),
               ("moe.shared", "repro_torch.models.moe", "_shared_expert"),
               ("moe.rest", "repro_torch.models.moe", "moe_ffn"),
               ("mlp", "repro_torch.models.transformer", "mlp_apply"),
               ("ssm", "repro_torch.models.ssm", "mamba_step"),
               ("attention", "repro_torch.models.attention",
                "paged_decode_attention"))


def labelled_split(targets, body, device, torch, warmup=None,
                   labels=None) -> dict:
    """Device time of one ``body()`` (which returns its wall seconds) by
    part: each ``(obj, attr, label)`` of ``targets`` (innermost first: a
    device event goes to the first label whose host range holds its
    launch) is wrapped in a profiler label for the window, and the time
    left is ``other``. ``labels``, where given, are the labels in that
    order, those ``body`` opens itself included. Device time from the
    window's trace (``kernel_audit.profile_window``, opened after
    ``warmup()``; each event under the label whose host range holds its
    launch)."""
    from torch.profiler import record_function

    from repro_torch.analysis import kernel_audit as ka

    saved = [getattr(obj, fn) for obj, fn, _label in targets]

    def labelled(inner, label):
        def call(*args, **kw):
            with record_function(label):
                return inner(*args, **kw)
        return call

    for (obj, fn, label), inner in zip(targets, saved):
        setattr(obj, fn, labelled(inner, label))
    try:
        prof, wall = ka.profile_window(body, device=device, warmup=warmup)
    finally:
        for (obj, fn, _label), inner in zip(targets, saved):
            setattr(obj, fn, inner)
    labels = list(labels or dict.fromkeys(label for _o, _f, label in targets))
    events = ka.trace_events(prof)
    by_label = ka.device_events_by_label(events,
                                         labels + [ka.WINDOW_MARKER_LABEL])
    check(ka.kernel_names(by_label[ka.WINDOW_MARKER_LABEL]),
          "the profiler's window lost its marker kernel: the split cannot be "
          "trusted to hold the whole step")
    marker = {id(e) for e in by_label[ka.WINDOW_MARKER_LABEL]}
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ka.DEVICE_CATS and id(e) not in marker]
    device_ms = sum(float(e.get("dur", 0)) for e in device) / 1e3
    split = {lab: sum(float(e.get("dur", 0)) for e in by_label[lab]) / 1e3
             for lab in labels}
    split["other"] = device_ms - sum(split.values())
    top = {}
    for e in device:
        top[e["name"][:70]] = top.get(e["name"][:70], 0.0) + \
            float(e.get("dur", 0)) / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "host_gap_ms": wall * 1e3 - device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "device_ms_by_part": split,
            "top_device_ms": dict(sorted(top.items(),
                                         key=lambda kv: -kv[1])[:10])}


def part_targets(parts, model) -> list:
    """``(object, function, label)`` targets of ``labelled_split`` for the
    ``(label, module, function)`` entries of ``parts`` (a module of
    ``None`` names a method of ``model``), and the model's head
    (``head``)."""
    import importlib

    return [(model if mod is None else importlib.import_module(mod), fn,
             label) for label, mod, fn in parts] + [(model, "logits", "head")]


def parts_decode_split(eng, prompts, ss: ServeSize, torch) -> dict:
    """Profiler split of one full-batch decode step by part: the MoE
    block's router (softmax and top-k), dispatch (sort, positions, the
    buffer), expert products, combine, shared experts and the rest of it
    (the router's product, the sum), or the dense MLP; the Mamba mixer
    (``ssm``, hybrid only); the attention (KV write and paged attention);
    the head; everything else (embedding, norms, projections), through
    :func:`labelled_split`."""
    for p in prompts[:ss.max_batch]:
        eng.submit(p, max_new_tokens=4)
    eng.step()                                 # prefill + first decode
    torch.cuda.synchronize()

    def decode_step():                         # a decode step, nothing else
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = labelled_split(part_targets(SPLIT_PARTS, eng.model), decode_step,
                         eng.pool.pool.device, torch, warmup=eng.step)
    eng.run()
    moe = eng.model.cfg.family == "moe"
    hybrid = eng.model.cfg.family == "hybrid"
    split = {k: v for k, v in out["device_ms_by_part"].items()
             if not k.startswith("mlp" if moe else "moe.")  # the other FFN
             and (hybrid or k != "ssm")}
    out["device_ms_by_part"] = split
    device_ms = out["device_ms"]
    if moe:
        out["moe_ms"] = sum(v for k, v in split.items()
                            if k.startswith("moe."))
        out["moe_share_of_device"] = out["moe_ms"] / device_ms
    if hybrid:
        out["ssm_share_of_device"] = split["ssm"] / device_ms
    check(split["attention"] > 0 and split["head"] > 0 and
          split["moe.experts" if moe else "mlp"] > 0 and
          (not hybrid or split["ssm"] > 0),
          f"the profiled step shows no attention, head, FFN or SSM: {out}")
    return out


def ssm_state_check(tag: str, got: dict, want: dict, diverged: list,
                    torch) -> dict:
    """The final ``ssm_state`` of a hybrid kernel run (``got``) against
    the plain run's: finite, and within ``SSM_STATE_TOL`` where no token
    diverged (a diverged token feeds the rows other inputs)."""
    out = {"tol": SSM_STATE_TOL, "compared": not diverged}
    for k in want:
        check(bool(torch.isfinite(got[k]).all()),
              f"{tag}: non-finite ssm_state[{k!r}]")
        out[k] = {"max_abs_err": float((got[k] - want[k]).abs().max()),
                  "max_abs_ref": float(want[k].abs().max())}
        if not diverged:
            check(torch.allclose(got[k], want[k], **SSM_STATE_TOL),
                  f"{tag}: ssm_state[{k!r}] of the kernel run differs from "
                  f"the plain run's: {out[k]}")
    return out


def config_runs(phase: str, runs, dev, torch, np, kattn) -> dict:
    """Each of ``runs`` in turn under LibraEngine, once through the kernels
    (``attn_impl='auto'``) and once through their plain versions
    (``'ref'``) on the same parameters (a fixed seed), freed before the
    next: stats, counters and pages as in phase 6, tokens under its
    near-tie rule (a moe run also under the router-margin rule), the
    kernels launched once a layer a prefill and a decode step, the moe
    runs' dropped entries equal, a hybrid run's final ``ssm_state`` within
    ``SSM_STATE_TOL`` where no token diverged. Prints one line for the
    phase."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import expert_capacity
    from repro_torch.models.registry import build_model

    out = {}
    for ss in runs:
        cfg = ss.config()
        moe = cfg.family == "moe"
        models = {impl: build_model(cfg, page_size=ss.page, attn_impl=impl)
                  for impl in ("auto", "ref")}
        t0 = time.perf_counter()
        params = models["auto"].init_params(ss.seed, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(ss.seed)
        prompts = [rng.integers(1, cfg.vocab_size - 1, ss.prompt)
                   for _ in range(ss.requests)]
        margins = LogitMargins(models["ref"])
        res, watches, ssm_states = {}, {}, {}
        for impl in ("auto", "ref"):
            with (RouterWatch(margins=impl == "ref") if moe
                  else contextlib.nullcontext()) as watch:
                eng, run = serve_run(ss, models[impl], params, prompts, dev,
                                     torch, kattn,
                                     margins if impl == "ref" else None,
                                     watch)
            if eng.ssm_state is not None:     # before the split's steps
                ssm_states[impl] = {k: v.clone()
                                    for k, v in eng.ssm_state.items()}
            run["decode_step_split"] = parts_decode_split(eng, prompts, ss,
                                                          torch)
            del eng
            res[impl], watches[impl] = run, watch
        kern, ref = res["auto"], res["ref"]
        tag = f"{phase} {ss.arch}"
        check(kern["stats"] == ref["stats"],
              f"{tag}: EngineStats differ between the kernel and plain runs")
        check(kern["counters"] == ref["counters"],
              f"{tag}: CopyCounters differ between the kernel and plain runs")
        st = kern["stats"]
        want = {"flash_attention": cfg.num_layers * st["prefills"],
                "paged_attention": cfg.num_layers * st["steps"]}
        check(kern["launches"] == want,
              f"{tag}: kernel launches {kern['launches']}, not {want}")
        check(not any(ref["launches"].values()),
              f"{tag}: a kernel launched in the plain run: {ref['launches']}")
        diverged = near_tie_diverged(ss, kern["outputs"], ref["outputs"],
                                     margins, f"{tag} kernel vs plain",
                                     watches["ref"])
        entry = {"layers": cfg.num_layers, "params": cfg.param_count(),
                 "param_gb": cfg.param_count() * 4 / 1e9,
                 "param_init_s": init_s, "requests": ss.requests,
                 "prompt": ss.prompt, "gen": ss.gen,
                 "max_batch": ss.max_batch, "page": ss.page,
                 "pool_pages": ss.pool_pages,
                 "identical_tokens": not diverged, "diverged": diverged,
                 "stats": st, "counters": kern["counters"]}
        if ss.layers:
            entry["reduced"] = {"num_layers": [
                ss.layers, get_config(ss.arch).num_layers]}
        if ssm_states:
            entry["hybrid"] = ssm_state_check(
                tag, ssm_states["auto"], ssm_states["ref"], diverged, torch)
            entry["hybrid"]["windows"] = sorted(set(models["auto"].windows))
            entry["hybrid"]["windowed_layers"] = sum(
                w > 0 for w in models["auto"].windows)
        if moe:
            drops = {impl: w.drops_by_step() for impl, w in watches.items()}
            totals = {impl: sum(w.drops) for impl, w in watches.items()}
            # the same entries dropped, call for call, up to the first call
            # at which the plain run's routing may flip
            calls = (watches["auto"].drops, watches["ref"].drops)
            check(len(calls[0]) == len(calls[1]),
                  f"{tag}: {len(calls[0])} and {len(calls[1])} MoE calls")
            differ = next((i for i, (a, b) in enumerate(zip(*calls))
                           if a != b), None)
            low = watches["ref"].first_low_margin()
            differs = None if differ is None else dict(
                call=differ, auto=calls[0][differ], ref=calls[1][differ],
                plain_margin=watches["ref"].margins[differ])
            check(differ is None or (low is not None and low["call"] <= differ),
                  f"{tag}: dropped entries differ at MoE call {differs} with "
                  f"no plain router margin below {ROUTER_MARGIN} at or "
                  f"before it (first: {low}); totals {totals}")
            entry["moe"] = {
                "experts": cfg.num_experts,
                "padded_experts": cfg.padded_experts, "top_k": cfg.top_k,
                "shared_experts": cfg.num_shared_experts,
                "prefill_rows": ss.max_batch * ss.prompt,
                "prefill_capacity": expert_capacity(
                    ss.max_batch * ss.prompt, cfg, 2.0),
                "dropped_entries": totals,
                "drops_differ_from": differs,
                "dropped_by_step": drops,
                "router_margin_by_step": watches["ref"].margin_by_step(),
                "first_router_margin_below": watches["ref"].first_low_margin()}
        keep = ("seconds", "tokens", "tokens_per_s", "p99_latency_ms",
                "ttft_s", "peak_mem_gb", "prefill_step_s", "decode_step_ms",
                "launches", "steps", "decode_step_split")
        entry["kernels"] = {k: kern[k] for k in keep}
        entry["plain"] = {k: ref[k] for k in keep}
        out[ss.arch] = entry
        del models, params, margins, watches, ssm_states
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": phase, "card": card_line(torch), "runs": out})
    return out



# ---------------------------------------------------------------------------
# phases 18-19: the vlm and encdec families, driven directly
# ---------------------------------------------------------------------------

class DirectRun:
    """One batch of ``ss.max_batch`` requests driven through a model's
    ``prefill`` / ``decode_step`` on a ``PagedKVPool`` of its own (no
    engine: the JAX package's engines feed no image and no frames, so these
    families are driven as ``XLSTMModel`` is). Every request has
    ``ss.prompt`` prefill positions (under ``vlm`` the image and then the
    text; under ``encdec`` the decoder prompt, after ``inputs['frames']``)
    anchored at prefill; decode step ``i`` is at position ``ss.prompt + i``,
    its page added by ``extend`` and its write found by ``write_coords``."""

    def __init__(self, ss: ServeSize, model, params, inputs: dict, dev,
                 torch):
        from repro_torch.serving.kv_cache import PagedKVPool

        self.ss, self.model, self.params = ss, model, params
        self.inputs, self.dev, self.torch = inputs, dev, torch
        self.kv = PagedKVPool(model, n_shards=1,
                              pages_per_shard=ss.pool_pages,
                              page_size=ss.page, device=dev)
        self.free0 = self.kv.alloc.free_pages
        self.handles = [self.kv.anchor_sequence(ss.prompt, header_len=0)
                        for _ in range(ss.max_batch)]
        self.cross_kv = self.cur = None
        self.pos = ss.prompt

    def _dev(self, *arrays):
        return [self.torch.from_numpy(a).to(self.dev) for a in arrays]

    def prefill(self) -> list:
        m, inp, ss = self.model, self.inputs, self.ss
        tables, _pp = self.kv.batch_tables(self.handles, ss.pps)
        tc = self.kv.token_coords(self.handles, ss.prompt)
        args = (self.params, inp["tokens"], inp["text_lens"], self.kv.pool,
                *self._dev(tables, *tc))
        if m.cfg.family == "encdec":
            self.cur, self.cross_kv = m.prefill(*args, inp["frames"])
        else:
            self.cur = m.prefill(*args, img_embeds=inp["img_embeds"])
        self.pos = ss.prompt
        return self.cur.tolist()                 # the step ends on a download

    def step(self) -> list:
        ss, b = self.ss, self.ss.max_batch
        for h in self.handles:
            self.kv.extend(h, self.pos + 1)
        tables, page_pos = self.kv.batch_tables(self.handles, ss.pps)
        wsh, wsl = self.kv.write_coords(self.handles, [self.pos] * b)
        seq_lens = self.torch.full((b,), self.pos, dtype=self.torch.int32,
                                   device=self.dev)
        extra = () if self.cross_kv is None else (self.cross_kv,)
        self.cur = self.model.decode_step(
            self.params, self.cur, seq_lens, self.kv.pool,
            *self._dev(tables, page_pos, wsh, wsl), *extra)
        self.pos += 1
        return self.cur.tolist()

    def close(self) -> None:
        """Release every request; all pages must come back."""
        for h in self.handles:
            self.kv.release(h)
        check(self.kv.alloc.free_pages == self.free0 and
              len(self.kv.registry) == 0,
              f"{self.ss.arch}: pages leaked ({self.kv.alloc.free_pages} of "
              f"{self.free0} free)")


def direct_inputs(ss: ServeSize, cfg, dev, torch, np) -> dict:
    """Seeded inputs of a direct run: text tokens ``[B, S_text]`` (all of
    one length), their lengths, and the image's patch embeddings ``[B,
    img_tokens, D]`` or the audio's frame embeddings ``[B, enc_frames,
    D]``, float32 standard normal, as the JAX package's tests make them."""
    rng = np.random.default_rng(ss.seed)
    b, text = ss.max_batch, ss.prompt - cfg.img_tokens
    out = {"tokens": torch.from_numpy(rng.integers(
               1, cfg.vocab_size - 1, (b, text)).astype(np.int32)).to(dev),
           "text_lens": torch.full((b,), text, dtype=torch.int32,
                                   device=dev)}
    if cfg.family == "vlm":
        out["img_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.img_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    else:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)).to(dev)
    return out


def direct_run(ss: ServeSize, model, params, inputs, dev, torch, kattn,
               prefill_launches: dict):
    """One prefill and ``gen - 1`` greedy decode steps; returns the run's
    numbers, its tokens ``[batch][gen]`` and (encdec) its ``cross_kv``.
    The kernels must launch ``prefill_launches`` at prefill and
    ``paged_attention`` once a decoder layer a step (none at all under the
    plain versions). Under encdec the encoder's part of the prefill
    (``encode_anchor``) is timed on its own, synchronised."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = DirectRun(ss, model, params, inputs, dev, torch)
    encode_s = []
    encdec = model.cfg.family == "encdec"
    if encdec:
        inner = model.encode_anchor

        def encode_anchor(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            encode_s.append(time.perf_counter() - t)
            return out
        model.encode_anchor = encode_anchor
    kattn.reset_launches()
    try:
        t0 = time.perf_counter()
        out = [run.prefill()]
        ttft = time.perf_counter() - t0
    finally:
        if encdec:
            del model.encode_anchor
    after_prefill = dict(kattn.LAUNCHES)
    step_s = []
    for _ in range(ss.gen - 1):
        ts = time.perf_counter()
        out.append(run.step())
        step_s.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    total = ttft + sum(step_s)
    launches = dict(kattn.LAUNCHES)
    tag = f"{ss.arch} {model.attn_impl}"
    layers = model.cfg.num_layers
    want_prefill = prefill_launches if model.attn_impl == "auto" else {
        k: 0 for k in prefill_launches}
    want = {"flash_attention": want_prefill["flash_attention"],
            "paged_attention": layers * (ss.gen - 1)
            if model.attn_impl == "auto" else 0}
    check(after_prefill == want_prefill,
          f"{tag}: prefill launched {after_prefill}, not {want_prefill}")
    check(launches == want, f"{tag}: the run launched {launches}, not {want}")
    cross_kv = run.cross_kv
    if cross_kv is not None:
        check(bool(torch.isfinite(cross_kv).all()),
              f"{tag}: non-finite cross_kv")
    run.close()
    b = ss.max_batch
    res = dict(attn_impl=model.attn_impl, seconds=total,
               tokens=b * ss.gen, tokens_per_s=b * ss.gen / total,
               ttft_s=ttft, prefill_tokens_per_s=b * ss.prompt / ttft,
               decode_step_ms={k: f(step_s) * 1e3 for k, f in (
                   ("min", min), ("median", statistics.median),
                   ("max", max))},
               decode_tokens_per_s=b * len(step_s) / sum(step_s),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches)
    if encode_s:
        res.update(encode_s=encode_s[0], decoder_prefill_s=ttft - encode_s[0])
    return res, [list(r) for r in zip(*out)], cross_kv


def rows_diverged(kern_rows, ref_rows, margins, gen: int, label: str) -> list:
    """The first token where each row of a kernel run driven directly
    (phases 8, 18, 19) leaves the plain run's; fails unless the plain
    run's top-2 logit margin there is below 1e-3 of the logits' spread
    (phase 6's near-tie rule). Call 0 of ``margins`` is the prefill (the
    first tokens), call i the decode step that gave token i."""
    diverged = []
    for row, (got, want) in enumerate(zip(kern_rows, ref_rows)):
        check(len(got) == len(want) == gen, f"{label}: row {row}: wrong "
                                            "length")
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     None)
        if first is None:
            continue
        margin_rows, spread_rows = margins.calls[first]
        d = dict(row=row, token=first, kernel=got[first], plain=want[first],
                 margin=margin_rows[row], spread=spread_rows[row])
        diverged.append(d)
        check(d["margin"] < 1e-3 * d["spread"],
              f"{label}: row {row} token {first}: kernel {d['kernel']} vs "
              f"plain {d['plain']}, plain top-2 margin {d['margin']} is not "
              f"below 1e-3 of the spread {d['spread']}")
    return diverged


#: profiler labels of a direct run's parts, (label, module, function): a
#: device event goes to the first whose host range holds its launch (the
#: encoder's attention and MLP to ``encoder``); the head is the model's
#: ``logits``
VLM_PARTS = (("img_proj", None, "embed"),
             ("mlp", "repro_torch.models.transformer", "mlp_apply"),
             ("attention", "repro_torch.models.attention",
              "prefill_attention"),
             ("attention", "repro_torch.models.attention",
              "paged_decode_attention"))
ENCDEC_PARTS = (("encoder", None, "encode"),
                ("cross_attention", "repro_torch.models.attention",
                 "noncausal_attention"),
                ("cross_attention", "repro_torch.models.attention",
                 "dense_attention"),
                ("mlp", "repro_torch.models.encdec", "mlp_apply"),
                ("attention", "repro_torch.models.attention",
                 "prefill_attention"),
                ("attention", "repro_torch.models.attention",
                 "paged_decode_attention"))


def direct_splits(ss: ServeSize, parts, model, params, inputs, dev,
                  torch) -> dict:
    """Profiler splits (:func:`labelled_split`) of a prefill and of a
    decode step of a fresh direct run, each window opened after one
    prefill or step of its own (a window opened on a prefill alone lost
    its marker kernel in a whole run on the card). A part
    whose module is ``None`` is a method of the model: under ``vlm`` its
    ``embed`` (``img_proj``: the image's projection, with the token lookup
    and the concatenation), under ``encdec`` its ``encode`` (the encoder
    under ``encode_anchor``, before the cross K/V projections)."""
    targets = part_targets(parts, model)
    own = set(vars(model))
    run = DirectRun(ss, model, params, inputs, dev, torch)

    def timed(fn):
        def body():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        return body

    try:
        out = {"prefill": labelled_split(targets, timed(run.prefill), dev,
                                         torch, warmup=run.prefill),
               "decode_step": labelled_split(targets, timed(run.step), dev,
                                             torch, warmup=run.step)}
    finally:           # labelled_split leaves the bound methods on the model
        for fn in set(vars(model)) - own:
            delattr(model, fn)
    run.close()
    return out


def direct_serve(phase: str, ss: ServeSize, dev, torch, np, kattn) -> dict:
    """Phases 18 and 19: ``ss`` driven directly, once through the kernels
    (``attn_impl='auto'``) and once through their plain versions
    (``'ref'``) on the same parameters and inputs; tokens under phase 6's
    near-tie rule, the launches of :func:`direct_run`, every page back,
    under encdec ``cross_kv`` of both runs within ``ATTN_TOL``; profiler
    splits of a prefill and a decode step of the kernel path. Prints one
    line for the phase."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = ss.config()
    encdec = cfg.family == "encdec"
    models = {impl: build_model(cfg, page_size=ss.page, attn_impl=impl)
              for impl in ("auto", "ref")}
    t0 = time.perf_counter()
    params = models["auto"].init_params(ss.seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    inputs = direct_inputs(ss, cfg, dev, torch, np)
    # a prefill attends once a layer; under encdec also once an encoder
    # layer and once more a decoder layer (the cross-attention)
    flash = cfg.enc_layers + 2 * cfg.num_layers if encdec else cfg.num_layers
    prefill_launches = {"flash_attention": flash, "paged_attention": 0}
    margins = LogitMargins(models["ref"])
    kern, kern_rows, kern_ckv = direct_run(ss, models["auto"], params, inputs,
                                           dev, torch, kattn,
                                           prefill_launches)
    ref, ref_rows, ref_ckv = direct_run(ss, models["ref"], params, inputs,
                                        dev, torch, kattn, prefill_launches)
    tag = f"{phase} {ss.arch}"
    diverged = rows_diverged(kern_rows, ref_rows, margins, ss.gen,
                             f"{tag} kernel vs plain")
    entry = {"arch": ss.arch, "card": card_line(torch), "family": cfg.family,
             "layers": cfg.num_layers, "params": cfg.param_count(),
             "param_gb": cfg.param_count() * 4 / 1e9, "param_init_s": init_s,
             "requests": ss.max_batch, "prefill_positions": ss.prompt,
             "text_tokens": ss.prompt - cfg.img_tokens, "gen": ss.gen,
             "page": ss.page, "pool_pages": ss.pool_pages,
             "identical_tokens": not diverged, "diverged": diverged,
             "prefill_launches": prefill_launches}
    if cfg.family == "vlm":
        entry["img_tokens"] = cfg.img_tokens
    if ss.layers:
        entry["reduced"] = {"num_layers": [ss.layers,
                                           get_config(ss.arch).num_layers]}
    if encdec:
        err = float((kern_ckv - ref_ckv).abs().max())
        close = torch.allclose(kern_ckv, ref_ckv, **ATTN_TOL)
        entry.update(enc_layers=cfg.enc_layers, enc_frames=cfg.enc_frames,
                     cross_kv_shape=list(kern_ckv.shape),
                     cross_kv_gb=kern_ckv.numel() * 4 / 1e9,
                     cross_kv={"tol": ATTN_TOL, "close": close,
                               "max_abs_err": err,
                               "max_abs_ref": float(ref_ckv.abs().max())})
        check(close, f"{tag}: cross_kv of the kernel run differs from the "
                     f"plain run's (max abs err {err})")
    del kern_ckv, ref_ckv
    splits = direct_splits(ss, ENCDEC_PARTS if encdec else VLM_PARTS,
                           models["auto"], params, inputs, dev, torch)
    step = splits["decode_step"]
    if encdec:
        step["cross_attention_share_of_device"] = \
            step["device_ms_by_part"]["cross_attention"] / step["device_ms"]
        check(splits["prefill"]["device_ms_by_part"]["encoder"] > 0 and
              step["device_ms_by_part"]["cross_attention"] > 0,
              f"{tag}: the split shows no encoder or cross-attention")
    else:
        check(splits["prefill"]["device_ms_by_part"]["img_proj"] > 0,
              f"{tag}: the prefill's split shows no img_proj product")
    check(step["device_ms_by_part"]["attention"] > 0 and
          step["device_ms_by_part"]["head"] > 0,
          f"{tag}: the step's split shows no attention or head")
    entry.update(kernels=kern, plain=ref, splits=splits)
    emit({"phase": phase, **entry})
    del models, params, inputs, margins
    gc.collect()
    torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# phases 7-8: mLSTM parity and the xLSTM run
# ---------------------------------------------------------------------------

def mlstm_case(gen, dev, torch, *, b, h, s, dh, extreme=False):
    """q, k, v [B, H, S, dh] ~ N(0, 1); log_i ~ N(0, 1) and log_f =
    logsigmoid(N(2, 1)), as the JAX package's tests draw them; ``extreme``
    draws log_i ~ N(0, 16) and log_f = logsigmoid(N(0, 16))."""
    F = torch.nn.functional

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q, k, v = rn(b, h, s, dh), rn(b, h, s, dh), rn(b, h, s, dh)
    if extreme:
        return q, k, v, rn(b, h, s) * 4, F.logsigmoid(rn(b, h, s) * 4)
    return q, k, v, rn(b, h, s), F.logsigmoid(rn(b, h, s) + 2)


def mlstm_parity(xs: XlstmSize, cfg, dev, torch, ops):
    """The mLSTM kernel against the plain chunked version on the card: h
    and the final (C, n, m)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    dh_run = cfg.ssm_expand * cfg.d_model // cfg.num_heads
    run = dict(b=xs.batch, h=cfg.num_heads, s=xs.prompt, dh=dh_run)
    # (label, shape, chunk, extreme): tests/test_kernels.py's shapes, its
    # gate extremes, ragged S, the (dh, chunk) pairs those leave out, and
    # the run's shape
    cases = [("b1h1-s64-dh32-c16", dict(b=1, h=1, s=64, dh=32), 16, False),
             ("b2h3-s64-dh32-c32", dict(b=2, h=3, s=64, dh=32), 32, False),
             ("b1h2-s128-dh64-c16", dict(b=1, h=2, s=128, dh=64), 16, False),
             ("extreme-b2h2-s64-dh16-c16", dict(b=2, h=2, s=64, dh=16), 16,
              True),
             ("extreme-b1h2-s64-dh16-c32", dict(b=1, h=2, s=64, dh=16), 32,
              True),
             ("ragged-b2h3-s100-dh32-c32", dict(b=2, h=3, s=100, dh=32), 32,
              False),
             ("ragged-b2h2-s70-dh64-c64", dict(b=2, h=2, s=70, dh=64), 64,
              False),
             ("ragged-b1h4-s1000-dh512-c64", dict(b=1, h=4, s=1000,
                                                  dh=dh_run), 64, False),
             ("b2h2-s192-dh16-c64", dict(b=2, h=2, s=192, dh=16), 64, False),
             ("ragged-b1h3-s160-dh32-c64", dict(b=1, h=3, s=160, dh=32), 64,
              False),
             ("b2h1-s96-dh64-c32", dict(b=2, h=1, s=96, dh=64), 32, False),
             ("ragged-b1h2-s300-dh512-c16", dict(b=1, h=2, s=300,
                                                 dh=dh_run), 16, False),
             ("b2h2-s256-dh512-c32", dict(b=2, h=2, s=256, dh=dh_run), 32,
              False),
             ("run", run, xs.chunk, False)]
    results = []
    for label, shape, chunk, extreme in cases:
        case = mlstm_case(gen, dev, torch, extreme=extreme, **shape)
        outs = [ops.mlstm_scan(*case, chunk=chunk, impl=impl,
                               return_state=True) for impl in ("cuda", "ref")]
        torch.cuda.synchronize()
        (hk, sk), (hr, sr) = outs
        tol = MLSTM_TOL_EXTREME if extreme else MLSTM_TOL
        pairs = dict(zip(("h", "C", "n", "m"), zip((hk, *sk), (hr, *sr))))
        errs = {k: float((a - b).abs().max()) for k, (a, b) in pairs.items()}
        ok = all(torch.isfinite(a).all() and torch.allclose(a, b, **tol)
                 for a, b in pairs.values())
        results.append(dict(kernel="mlstm_scan", case=label, close=bool(ok),
                            dh=shape["dh"], chunk=chunk,
                            tol=tol, max_abs_err=max(errs.values()),
                            max_abs_err_by_output=errs))
        if label == "run":  # both against the plain version in float64
            h64, s64 = ops.mlstm_scan(*(x.double() for x in case),
                                      chunk=chunk, impl="ref",
                                      return_state=True)
            results[-1]["vs_f64"] = {
                who: {k: float((a.double() - b).abs().max())
                      for k, a, b in zip(("h", "C"), (hh, st[0]),
                                         (h64, s64[0]))}
                for who, hh, st in (("kernel", hk, sk), ("plain", hr, sr))}
            del h64, s64
        check(ok, f"mlstm_scan [{label}] differs from its plain version "
                  f"(max abs errors {errs}, tolerance {tol})")
    pairs = {(r["dh"], r["chunk"]) for r in results}
    check(len(pairs) == 12, f"mlstm_parity reaches {len(pairs)} of the 12 "
                            "(dh, chunk) instantiations")
    emit({"phase": "mlstm_parity", "cases": len(results),
          "instantiations": len(pairs),
          "all_close": all(r["close"] for r in results),
          "tol": MLSTM_TOL, "tol_gate_extremes": MLSTM_TOL_EXTREME,
          "max_abs_err": {r["case"]: r["max_abs_err_by_output"]
                          for r in results},
          "run_vs_f64": results[-1]["vs_f64"]})
    return results


def xlstm_run(xs: XlstmSize, model, params, tokens, seq_lens, torch,
              kmlstm):
    """One prefill and ``gen - 1`` greedy decode steps; returns the run's
    numbers, its tokens and a copy of the decode state after prefill."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kmlstm.reset_launches()
    t0 = time.perf_counter()
    first, state = model.prefill(params, tokens, seq_lens)
    out = [first.tolist()]                 # the step ends on a download
    prefill_s = time.perf_counter() - t0
    after_prefill = {k: v.clone() for k, v in state.items()}
    cur, step_s = first, []
    for i in range(xs.gen - 1):
        ts = time.perf_counter()
        cur, state = model.decode_step(params, cur, seq_lens + i, state)
        out.append(cur.tolist())
        step_s.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    total = prefill_s + sum(step_s)
    finite = all(bool(torch.isfinite(v).all()) for v in state.values())
    check(finite, f"{model.mlstm_impl}: non-finite decode state")
    run = dict(mlstm_impl=model.mlstm_impl, prefill_s=prefill_s,
               prefill_tokens_per_s=xs.batch * xs.prompt / prefill_s,
               decode_step_ms={k: f(step_s) * 1e3 for k, f in (
                   ("min", min), ("median", statistics.median),
                   ("max", max))},
               decode_tokens_per_s=xs.batch * len(step_s) / sum(step_s),
               seconds=total, tokens_per_s=xs.batch * xs.gen / total,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=dict(kmlstm.LAUNCHES))
    rows = [list(r) for r in zip(*out)]    # [batch][gen]
    return run, rows, after_prefill


def prefill_split(model, params, tokens, seq_lens, torch):
    """One profiled prefill: device time by kernel kind, and the host wall
    of the mLSTM scans (transposes in, scan; synchronised) and of the
    sLSTM step loops; host gaps are wall minus device time. Only device
    activity is traced, and the raw trace events are summed: the 3 x 4096
    sLSTM steps launch about 250 000 kernels, too many to turn into
    ``key_averages``' per-op events within the script's time."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm

    wall = {"mlstm_scan_calls": 0.0, "slstm_step_loops": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            wall[key] += time.perf_counter() - t
            return out
        return run
    scan, loop = ssm.ops.mlstm_scan, ssm._slstm_scan
    ssm.ops.mlstm_scan = timed("mlstm_scan_calls", scan)
    ssm._slstm_scan = timed("slstm_step_loops", loop)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill(params, tokens, seq_lens)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        ssm.ops.mlstm_scan, ssm._slstm_scan = scan, loop
    kinds = {"mlstm_scan": re.compile(r"mlstm_scan"),
             "matmul": re.compile(r"gemm|gemv|xmma|cutlass|splitK|dot_kernel",
                                  re.I),
             "copies": re.compile(r"copy|memcpy|memset", re.I)}
    split = {k: 0.0 for k in (*kinds, "other")}
    top, n_events = {}, 0
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        n_events += 1
        ms = e.duration_ns() / 1e6
        kind = next((k for k, rx in kinds.items() if rx.search(e.name())),
                    "other")
        split[kind] += ms
        top[e.name()[:70]] = top.get(e.name()[:70], 0.0) + ms
    device_ms = sum(split.values())
    check(split["mlstm_scan"] > 0, "the profiled prefill ran no mlstm_scan")
    return {"wall_s": wall_s, "device_s": device_ms / 1e3,
            "host_gap_s": wall_s - device_ms / 1e3,
            "device_busy_share": device_ms / 1e3 / wall_s,
            "device_events": n_events,
            "device_ms_by_kind": split,
            "host_wall_s_synchronised": wall,
            "top_device_ms": dict(sorted(top.items(),
                                         key=lambda kv: -kv[1])[:10])}


def scan_state(model, params, tokens, seq_lens, torch, dtype):
    """The decode state after a prefill whose mLSTM scans run the plain
    chunked version on inputs cast to ``dtype`` (everything else as in the
    plain run). float64 gives the yardstick both float32 runs are measured
    against; bfloat16 (inputs rounded, computed in float32) gives the
    control the state rule must flag."""
    from repro_torch.models import ssm

    scan = ssm.ops.mlstm_scan

    def cast(q, k, v, log_i, log_f, *, chunk, impl, return_state):
        h, st = scan(*(t.to(dtype) for t in (q, k, v, log_i, log_f)),
                     chunk=chunk, impl="ref", return_state=True)
        return h.float(), tuple(t.float() for t in st)
    ssm.ops.mlstm_scan = cast
    try:
        return model.prefill(params, tokens, seq_lens)[1]
    finally:
        ssm.ops.mlstm_scan = scan


def xlstm_serve(xs: XlstmSize, dev, torch, np, kmlstm):
    """xlstm-350m prefill + decode, the kernel against the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(xs.arch)
    models = {impl: build_model(cfg, mlstm_impl=impl)
              for impl in ("auto", "ref")}
    t0 = time.perf_counter()
    params = models["auto"].init_params(xs.seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(xs.seed)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size - 1, (xs.batch, xs.prompt)).astype(np.int32)).to(dev)
    seq_lens = torch.full((xs.batch,), xs.prompt, dtype=torch.int32,
                          device=dev)
    # the plain run's logits calls: call 0 is the prefill (the first
    # tokens), call i the decode step that gave token i
    margins = LogitMargins(models["ref"])
    kern_run, kern_rows, kern_state = xlstm_run(
        xs, models["auto"], params, tokens, seq_lens, torch, kmlstm)
    split = prefill_split(models["auto"], params, tokens, seq_lens, torch)
    ref_run, ref_rows, ref_state = xlstm_run(
        xs, models["ref"], params, tokens, seq_lens, torch, kmlstm)
    y_state = scan_state(models["ref"], params, tokens, seq_lens, torch,
                         torch.float64)
    ctl_state = scan_state(models["ref"], params, tokens, seq_lens, torch,
                           torch.bfloat16)
    n_mlstm = models["auto"].n_mlstm
    # the decode state after prefill: distances to the run whose scans
    # are computed in float64, and each run's ratio to the plain run's
    state_err, far = {}, []
    for key, y in y_state.items():
        e_kern = float((kern_state[key] - y).abs().max())
        e_plain = float((ref_state[key] - y).abs().max())
        e_ctl = float((ctl_state[key] - y).abs().max())
        scale = float(y.abs().max())
        slack = 1e-6 * scale
        state_err[key] = {
            "kernel_vs_plain": float((kern_state[key] - ref_state[key])
                                     .abs().max()),
            "kernel_vs_f64": e_kern, "plain_vs_f64": e_plain,
            "bf16_control_vs_f64": e_ctl,
            "kernel_ratio": e_kern / max(e_plain, slack),
            "bf16_control_ratio": e_ctl / max(e_plain, slack),
            "max_abs": scale}
        if e_kern > XLSTM_STATE_FACTOR * e_plain + slack:
            far.append(key)
        if e_ctl > XLSTM_STATE_FACTOR * e_plain + slack:
            state_err[key]["bf16_control_flagged"] = True
    del kern_state, ref_state, y_state, ctl_state
    ratios = {r: max(e[r] for e in state_err.values())
              for r in ("kernel_ratio", "bf16_control_ratio")}
    diverged = rows_diverged(kern_rows, ref_rows, margins, xs.gen,
                             "xlstm_serve kernel vs plain")
    emit({"phase": "xlstm_serve", "arch": xs.arch,
          "params": cfg.param_count(), "param_init_s": init_s,
          "mlstm_blocks": n_mlstm, "slstm_blocks": models["auto"].n_slstm,
          "batch": xs.batch, "prompt": xs.prompt, "gen": xs.gen,
          "identical_tokens": not diverged, "diverged": diverged,
          "state_rule": f"max |kernel - f64| <= {XLSTM_STATE_FACTOR} x "
                        "max |plain - f64| + 1e-6 x max |f64|",
          "state_after_prefill": state_err,
          "max_kernel_ratio": ratios["kernel_ratio"],
          "max_bf16_control_ratio": ratios["bf16_control_ratio"],
          "kernels": kern_run, "plain": ref_run, "prefill_split": split})
    check(kern_run["launches"]["mlstm_scan"] == n_mlstm,
          f"mlstm_scan launched {kern_run['launches']['mlstm_scan']} times "
          f"in the kernel run, expected one per mLSTM block ({n_mlstm})")
    check(ref_run["launches"]["mlstm_scan"] == 0,
          "mlstm_scan launched in the plain run")
    check(not far, f"decode state {far} after prefill: the kernel run is "
                   "farther from the float64-scan run than the rule allows")
    check(any(e.get("bf16_control_flagged") for e in state_err.values()),
          "the state rule passes the bfloat16-input control: it cannot "
          "tell a faulty scan from a sound one")
    del params
    torch.cuda.empty_cache()
    return kern_run


# ---------------------------------------------------------------------------
# phase 9: timing
# ---------------------------------------------------------------------------

def time_ms(fn, torch, runs: int = TIMED_RUNS, clean_l2: bool = False
            ) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each call,
    the 50 MB L2 flushed before it (the round's operands arrive cold). A
    spin kernel holds the stream while the host enqueues the start event,
    the call and the end event, so the host's launch overhead is not
    counted; a call that waits on the device itself (the plain versions'
    masked indexing) still counts its host gaps. The flush writes 64 MB,
    so the L2 holds dirty lines whose write-back falls inside the timed
    call; ``clean_l2`` flushes by reading 64 MB instead."""
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if clean_l2:
            flush.view(torch.float32).sum()
        else:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def anchored_tokens(ml, tl, tables, page, s, np) -> int:
    """Payload tokens the anchor writes for these inputs."""
    b, pps = tables.shape
    rel = np.arange(pps * page)[None, :]
    pid = np.repeat(tables, page, axis=1)
    pos = ml[:, None].astype(np.int64) + rel
    ok = (pid >= 0) & (rel < (tl - ml)[:, None]) & (pos >= 0) & (pos < s)
    return int(ok.sum())


def gathered_tokens(tables, lengths, page, np) -> int:
    b, pps = tables.shape
    rel = np.arange(pps * page)[None, :]
    ok = (np.repeat(tables, page, axis=1) >= 0) & (rel < lengths[:, None])
    return int(ok.sum())


def policy_refs(off, ml, m, plen, w, np) -> int:
    """Distinct metadata / window tokens the conditions read, summed over
    the messages."""
    off = off.reshape(-1)
    meta_offs = np.unique(off[off >= 0])
    pay_pos = np.unique(-off[off <= -2] - 2)
    n = 0
    for i in range(len(ml)):
        n += int(((meta_offs < ml[i]) & (meta_offs < m)).sum())
        n += int(((pay_pos < plen[i]) & (pay_pos < w)).sum())
    return n


def peak_ops_per_s(torch, per_sm_clock: int) -> float:
    """Peak operations per second of the current card for an instruction
    type that issues ``per_sm_clock`` results per SM per clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    return sms * per_sm_clock * float(mhz) * 1e6


def bound(bytes_: int, ops_: int, ops_per_s: float):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_)


def mlstm_timing_case(xs: XlstmSize, gen, dev, torch):
    """Inputs of one mLSTM block of the xLSTM prefill, its label, the
    function's operations and bytes. Per (row, head, chunk): q kT and
    (S o qk) v over the causal triangle, c(c+1)/2 dh multiply-adds each (the
    gate matrix is -1e30 above the diagonal), q C and (k w)T v, c dh^2 each;
    q, k, v, the gates read once, h and the final state written once. No
    single PyTorch call computes an mLSTM."""
    from repro_torch.configs import get_config

    xcfg = get_config(xs.arch)
    dh = xcfg.ssm_expand * xcfg.d_model // xcfg.num_heads
    mc = mlstm_case(gen, dev, torch, b=xs.batch, h=xcfg.num_heads,
                    s=xs.prompt, dh=dh)
    c, bh = xs.chunk, xs.batch * xcfg.num_heads
    chunks = -(-xs.prompt // c)
    flops = 2 * bh * chunks * (c * (c + 1) * dh + 2 * c * dh * dh)
    nbytes = 4 * (4 * mc[0].numel() + 2 * mc[3].numel()
                  + bh * (dh * dh + dh + 1))
    label = (f"B={xs.batch} H={xcfg.num_heads} S={xs.prompt} dh={dh} "
             f"chunk={c}")
    return mc, label, flops, nbytes


def flash_timing_case(ss: ServeSize, cfg, gen, dev, torch, window=0):
    """Inputs of one layer's prefill attention of a full wave, causal, its
    label, the function's operations and bytes: 4 hd multiply-add
    operations per (query head, query, key) pair of the causal triangle
    (with ``window``, the pairs ``i - j < window`` of it); q, k, v read
    once, the output written once."""
    fq, fk, fv = flash_case(gen, dev, torch, b=ss.max_batch,
                            hq=cfg.num_heads, hkv=cfg.num_kv_heads,
                            s=ss.prompt, hd=cfg.head_dim)
    pairs = sum(min(i + 1, window) if window > 0 else i + 1
                for i in range(ss.prompt))
    flops = 4 * ss.max_batch * cfg.num_heads * cfg.head_dim * pairs
    nbytes = 4 * 2 * (fq.numel() + fk.numel())
    label = f"{ss.arch} B={ss.max_batch} S={ss.prompt} causal" + (
        f" window={window}" if window else "")
    return (fq, fk, fv), label, flops, nbytes


def copy_timing_case(size: Size, rng, dev, np, tt):
    """The deployment's RX selective copy (64 rows, 256 metadata tokens,
    16 pages of 1024 tokens, meta_len drawn from [0, 256], anchored into
    the 128 MiB pool), the tokens it writes, and the bytes and operations
    of each variant: the payload lanes of the stream (and keystream) and
    the metadata prefixes read, the table and lengths read, the pool
    tokens and the [B, meta_max] block written."""
    case = widen(selcopy_dict(tt.selcopy_crypto_case(
        rng, b=size.channels, page=size.page, pps=size.pps,
        meta_max=size.meta_max)), size.pool_rows, rng, np)
    c = tt.to_torch(case, dev)
    ml, tl, tb = case["meta_len"], case["total_len"], case["tables"]
    b, s = case["stream"].shape
    n_pay = anchored_tokens(ml, tl, tb, size.page, s, np)
    n_meta = int(np.minimum(ml, size.meta_max).sum())
    writes = n_pay + b * size.meta_max

    def cost(crypto):
        reads = n_pay * (2 if crypto else 1) + n_meta + tb.size + 2 * b
        return 4 * (reads + writes), n_pay * (1 + crypto)
    return c, writes, cost


def policy_timing_case(size: Size, rng, dev, np, tt):
    """The deployment's policy match (64 messages, 256 metadata tokens,
    the three-rule table, a payload window of one page), and the bytes
    and operations of each variant: the tokens the conditions read (twice
    with the keystream), the table, the lengths, the verdicts."""
    meta, pml, off, lo, hi, pks, pw, pln = tt.policy_payload_case(
        rng, b=size.channels, meta_max=size.meta_max, r=3, k=1, w=size.page)
    p = tt.to_torch(dict(meta=meta, ml=pml, off=off, lo=lo, hi=hi, ks=pks,
                         pw=pw, pln=pln), dev)
    refs = policy_refs(off, pml, size.meta_max, pln, size.page, np)

    def cost(crypto):
        reads = refs * (2 if crypto else 1) + 3 * off.size + 2 * len(pml)
        return 4 * (reads + len(pml)), 3 * refs
    return p, cost


def gather_timing_case(size: Size, rng, dev, np, tt):
    """The deployment's egress gather (64 rows x 16 pages of 1024 tokens
    out of the 128 MiB pool), the index of its table rows for
    ``index_select``, and the bytes the function moves: the live pool
    tokens (and as many keystream tokens) read, the table and lengths
    read, the whole output written."""
    pool, tables, lengths, gks = tt.selgather_case(
        rng, b=size.channels, page=size.page, pps=size.pps,
        p_total=size.pool_rows - 1)
    g = tt.to_torch(dict(pool=pool, tables=tables, lengths=lengths, ks=gks),
                    dev)
    n_g = gathered_tokens(tables, lengths, size.page, np)
    rows_idx = g["tables"].reshape(-1).long().clamp(min=0)

    def nbytes(crypto):
        reads = n_g * (2 if crypto else 1) + tables.size + len(lengths)
        return 4 * (reads + tables.size * size.page)
    return g, rows_idx, n_g, nbytes


def fused_timing_case(size: Size, rng, dev, np, tt):
    """The deployment's fused round (64 rows, 16 pages of 1024 tokens,
    256 metadata tokens, the three-rule table), its operands by variant
    and the bytes and operations of each: payload lanes of the stream (and
    RX and TX keystreams) read, written once to the pool and once to the
    output, the metadata block, the tokens the conditions read, the
    tables."""
    big = dict(b=size.channels, page=size.page, pps=size.pps,
               meta_max=size.meta_max)
    page, mm = size.page, size.meta_max
    case = widen(tt.fused_round_case(rng, r=3, k=1, **big), size.pool_rows,
                 rng, np)
    f = tt.to_torch(case, dev)
    ml, tl, tb = case["meta_len"], case["total_len"], case["tables"]
    b, s = case["stream"].shape
    n_pay = anchored_tokens(ml, tl, tb, page, s, np)
    n_meta = int(np.minimum(ml, mm).sum())
    refs = policy_refs(case["cond_off"], ml, mm, tl - ml, page, np)
    variants = {}
    for crypto in (False, True):
        keys = ["cond_off", "cond_lo", "cond_hi"]
        if crypto:
            keys += ["keystream", "tx_keystream"]
        per_tok = 3 if crypto else 1        # stream (+ RX ks, + TX ks)
        reads = (n_pay * per_tok + n_meta + refs * (2 if crypto else 1)
                 + tb.size + 2 * b + 3 * case["cond_off"].size)
        writes = n_pay + b * mm + tb.size * page + b
        variants["ks+policy" if crypto else "plain+policy"] = (
            {k: f[k] for k in keys}, 4 * (reads + writes),
            n_pay * (1 + 2 * crypto) + 3 * refs)
    return f, variants


def both_flushes(fn, torch) -> dict:
    """``time_ms`` of ``fn`` under the write flush and with a clean L2."""
    return {"dirty_l2": time_ms(fn, torch),
            "clean_l2": time_ms(fn, torch, clean_l2=True)}


def empty_kernel_ms(torch) -> dict:
    """This timing's floor under both flushes: ``time_ms`` of a kernel
    that returns at once (``torch.cuda._sleep(0)``, one block of one
    thread)."""
    return both_flushes(lambda: torch.cuda._sleep(0), torch)


def card_line(torch) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    check(smi, "nvidia-smi printed nothing")
    return smi


def timing(size: Size, ss: ServeSize, xs: XlstmSize, dev, torch, np, ops,
           tt, hs: ServeSize = HYBRID_RUNS[0], vs: ServeSize = VLM_RUN,
           es: ServeSize = ENCDEC_RUN):
    rng = np.random.default_rng(29)
    mm = size.meta_max
    rate = peak_ops_per_s(torch, INT32_OPS_PER_SM_CLOCK)
    frate = peak_ops_per_s(torch, FP32_OPS_PER_SM_CLOCK)
    out = {}

    def entry(name, variant, k_fn, r_fn, bnd, lib_fn=None, ops_rate=rate,
              clean=False):
        b_ms, b_by, b_bytes = bound(*bnd, ops_rate)
        row = dict(variant=variant, ms=time_ms(k_fn, torch),
                   plain_ms=time_ms(r_fn, torch, runs=20) if r_fn else None,
                   bound_ms=b_ms, bound_by=b_by, bytes=b_bytes,
                   library_ms=(time_ms(lib_fn, torch) if lib_fn else None))
        if clean:   # the same after a 64 MB read, which leaves no dirty line
            row.update(ms_clean_l2=time_ms(k_fn, torch, clean_l2=True))
            if lib_fn:
                row.update(library_ms_clean_l2=time_ms(lib_fn, torch,
                                                       clean_l2=True))
        out.setdefault(name, []).append(row)
        return row

    floor = empty_kernel_ms(torch)
    emit({"phase": "timing_floor", "empty_kernel_ms": floor["dirty_l2"],
          "empty_kernel_ms_clean_l2": floor["clean_l2"],
          "what": "time_ms of torch.cuda._sleep(0), under the write flush "
                  "and after a clean-L2 read"})
    # selective_copy, beside the floor
    c, _writes, c_cost = copy_timing_case(size, rng, dev, np, tt)
    for crypto in (False, True):
        ks = c["keystream"] if crypto else None
        row = entry("selective_copy", "ks" if crypto else "plain",
                    lambda: ops.selective_copy(c["stream"], c["meta_len"],
                                               c["total_len"], c["pool"],
                                               c["tables"], meta_max=mm,
                                               impl="cuda", keystream=ks),
                    lambda: ops.selective_copy(c["stream"], c["meta_len"],
                                               c["total_len"], c["pool"],
                                               c["tables"], meta_max=mm,
                                               impl="ref", keystream=ks),
                    c_cost(crypto), clean=True)
        row.update(empty_kernel_ms=floor)
    # selective_gather, beside index_select of its rows and a copy_ of as
    # many bytes as it writes
    g, rows_idx, n_g, g_bytes = gather_timing_case(size, rng, dev, np, tt)
    src = torch.empty_like(g["ks"])
    dst = torch.empty_like(src)
    copy_ms = both_flushes(lambda: dst.copy_(src), torch)
    for crypto in (False, True):
        ks = g["ks"] if crypto else None
        row = entry("selective_gather", "ks" if crypto else "plain",
                    lambda: ops.selective_gather(g["pool"], g["tables"],
                                                 g["lengths"], impl="cuda",
                                                 keystream=ks),
                    lambda: ops.selective_gather(g["pool"], g["tables"],
                                                 g["lengths"], impl="ref",
                                                 keystream=ks),
                    (g_bytes(crypto), n_g * crypto),
                    lib_fn=lambda: torch.index_select(g["pool"], 0,
                                                      rows_idx),
                    clean=True)
        row.update(same_bytes_copy_ms=copy_ms)
    del src, dst
    # policy_match: the deployment's three rules, payload window on,
    # beside the floor
    p, p_cost = policy_timing_case(size, rng, dev, np, tt)
    for crypto in (False, True):
        ks = p["ks"] if crypto else None
        row = entry("policy_match", "ks" if crypto else "plain",
                    lambda: ops.policy_match(
                        p["meta"], p["ml"], p["off"], p["lo"], p["hi"],
                        impl="cuda", keystream=ks, payload=p["pw"],
                        payload_len=p["pln"]),
                    lambda: ops.policy_match(
                        p["meta"], p["ml"], p["off"], p["lo"], p["hi"],
                        impl="ref", keystream=ks, payload=p["pw"],
                        payload_len=p["pln"]),
                    p_cost(crypto), clean=True)
        row.update(empty_kernel_ms=floor)
    # fused_round: plaintext with policy, then both keystreams + policy,
    # at each ring depth (the first row, n_buffers = 0, is the main path's)
    f, fvars = fused_timing_case(size, rng, dev, np, tt)
    for vname, (kw, nbytes, nops) in fvars.items():
        for depth in FUSED_DEPTHS:
            entry("fused_round", f"{vname} n_buffers={depth}",
                  lambda: ops.fused_round(f["stream"], f["meta_len"],
                                          f["total_len"], f["pool"],
                                          f["tables"], meta_max=mm,
                                          impl="cuda", n_buffers=depth,
                                          **kw),
                  None if depth else (
                      lambda: ops.fused_round(f["stream"], f["meta_len"],
                                              f["total_len"], f["pool"],
                                              f["tables"], meta_max=mm,
                                              impl="ref", **kw)),
                  (nbytes, nops), clean=True)
    # paged_attention: one layer of a decode step of a full wave
    from repro_torch.configs import get_config

    cfg = get_config(ss.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    pc, label, flops, nbytes = paged_timing_case(ss, cfg, gen, dev, torch)
    entry("paged_attention", label,
          lambda: ops.paged_attention(*pc, impl="cuda"),
          lambda: ops.paged_attention(*pc, impl="ref"),
          (nbytes, flops), ops_rate=frate)
    # flash_attention: one layer of a prefill of a full wave, causal
    trate = peak_ops_per_s(torch, TF32_OPS_PER_SM_CLOCK)
    (fq, fk, fv), label, flops, nbytes = flash_timing_case(ss, cfg, gen, dev,
                                                           torch)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry("flash_attention", label,
          lambda: ops.flash_attention(fq, fk, fv, impl="cuda"),
          lambda: ops.flash_attention(fq, fk, fv, impl="ref"),
          (nbytes, TF32_SPLIT_PASSES * flops),
          lib_fn=lambda: sdpa(fq, fk, fv, is_causal=True, enable_gqa=True),
          ops_rate=trate)
    out["flash_attention"][-1].update(
        function_flop=flops,
        fp32_fma_bound_ms=bound(nbytes, flops, frate)[0])
    del fq, fk, fv, pc
    # both again at the windowed layers of hymba (phase 17); the library
    # call takes the causal band as a boolean mask
    hcfg = hs.config()
    pc, label, flops, nbytes = paged_timing_case(hs, hcfg, gen, dev, torch,
                                                 hcfg.window)
    entry("paged_attention", label,
          lambda: ops.paged_attention(*pc, window=hcfg.window, impl="cuda"),
          lambda: ops.paged_attention(*pc, window=hcfg.window, impl="ref"),
          (nbytes, flops), ops_rate=frate)
    (fq, fk, fv), label, flops, nbytes = flash_timing_case(
        hs, hcfg, gen, dev, torch, hcfg.window)
    iq = torch.arange(hs.prompt, device=dev)
    band = (iq[:, None] >= iq[None, :]) & \
        (iq[:, None] - iq[None, :] < hcfg.window)
    entry("flash_attention", label,
          lambda: ops.flash_attention(fq, fk, fv, window=hcfg.window,
                                      impl="cuda"),
          lambda: ops.flash_attention(fq, fk, fv, window=hcfg.window,
                                      impl="ref"),
          (nbytes, TF32_SPLIT_PASSES * flops),
          lib_fn=lambda: sdpa(fq, fk, fv, attn_mask=band, enable_gqa=True),
          ops_rate=trate)
    out["flash_attention"][-1].update(
        function_flop=flops,
        fp32_fma_bound_ms=bound(nbytes, flops, frate)[0])
    del fq, fk, fv, pc, band
    # both at the shapes of phases 18-19 (rows marked ``shape_of``): the
    # decode step of internvl2 (GQA 64/8 of 128) and of whisper (16/16 of
    # 64), internvl2's prefill (causal) and whisper's two non-causal
    # prefill calls over the keys noncausal_attention pads (the encoder's
    # 1500 frames and the decoder's prompt over 1536 keys); the bound
    # counts the whole Sq x Skv rectangle, and SDPA (float32, non-causal)
    # computes the same function
    for phase, run in (("vlm_serve", vs), ("encdec_serve", es)):
        rcfg = run.config()
        pc, label, flops, nbytes = paged_timing_case(run, rcfg, gen, dev,
                                                     torch)
        entry("paged_attention", label,
              lambda: ops.paged_attention(*pc, impl="cuda"),
              lambda: ops.paged_attention(*pc, impl="ref"),
              (nbytes, flops), ops_rate=frate).update(shape_of=phase)
        del pc
    vcfg = vs.config()
    (fq, fk, fv), label, flops, nbytes = flash_timing_case(vs, vcfg, gen, dev,
                                                           torch)
    entry("flash_attention", label,
          lambda: ops.flash_attention(fq, fk, fv, impl="cuda"),
          lambda: ops.flash_attention(fq, fk, fv, impl="ref"),
          (nbytes, TF32_SPLIT_PASSES * flops),
          lib_fn=lambda: sdpa(fq, fk, fv, is_causal=True, enable_gqa=True),
          ops_rate=trate)
    out["flash_attention"][-1].update(
        shape_of="vlm_serve", function_flop=flops,
        fp32_fma_bound_ms=bound(nbytes, flops, frate)[0])
    del fq, fk, fv
    for name, shape in encdec_flash_shapes(es, es.config()).items():
        fq, fk, fv = flash_case(gen, dev, torch, **shape)
        flops = 4 * shape["b"] * shape["hq"] * shape["hd"] * shape["s"] * \
            shape["skv"]
        nbytes = 4 * 2 * (fq.numel() + fk.numel())
        entry("flash_attention",
              f"{es.arch} {name} B={shape['b']} Sq={shape['s']} "
              f"Skv={shape['skv']} non-causal",
              lambda: ops.flash_attention(fq, fk, fv, causal=False,
                                          impl="cuda"),
              lambda: ops.flash_attention(fq, fk, fv, causal=False,
                                          impl="ref"),
              (nbytes, TF32_SPLIT_PASSES * flops),
              lib_fn=lambda: sdpa(fq, fk, fv), ops_rate=trate)
        out["flash_attention"][-1].update(
            shape_of="encdec_serve", function_flop=flops,
            fp32_fma_bound_ms=bound(nbytes, flops, frate)[0])
        del fq, fk, fv
    # mlstm_scan: one mLSTM block of the xLSTM prefill
    mc, label, flops, nbytes = mlstm_timing_case(xs, gen, dev, torch)
    c = xs.chunk
    entry("mlstm_scan", label,
          lambda: ops.mlstm_scan(*mc, chunk=c, impl="cuda",
                                 return_state=True),
          lambda: ops.mlstm_scan(*mc, chunk=c, impl="ref",
                                 return_state=True),
          (nbytes, TF32_SPLIT_PASSES * flops), ops_rate=trate)
    out["mlstm_scan"][-1].update(
        function_flop=flops,
        fp32_fma_bound_ms=bound(nbytes, flops, frate)[0])
    emit({"phase": "timing", "runs": TIMED_RUNS, "empty_kernel_ms": floor,
          "int32_ops_per_s": rate, "fp32_ops_per_s": frate,
          "tf32_ops_per_s": trate,
          "hbm_bytes_per_s": HBM_BYTES_PER_S, "kernels": out})
    return out


# ---------------------------------------------------------------------------
# --mlstm-ab, --flash-ab, --paged-ab: one kernel's checks and timing for
# other builds
# ---------------------------------------------------------------------------

def build_variants(paths, _build, symbol: str, instance: str):
    """Compile each version of one kernel's source into its own library
    under ``build/ab/`` (one ``nvcc`` each, all at once) and load it with
    the C entry point ``symbol``; print each build's ``ptxas -v`` and SASS
    opcode mix of the kernel whose mangled name matches ``instance`` (a
    regular expression)."""
    import ctypes
    import hashlib
    import re

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, jobs = _build._nvcc(), []
    t0 = time.perf_counter()
    for p in paths:
        src = Path(p).resolve()
        # a header next to the source (an earlier commit's, unpacked with
        # it) is found before the one in csrc/
        headers = sorted(src.parent.glob("*.cuh")) + sorted(
            _build.CSRC.glob("*.cuh"))
        tag = hashlib.sha256(src.read_bytes()
                             + b"".join(h.read_bytes() for h in headers)
                             + " ".join(_build.NVCC_FLAGS).encode())
        so = out_dir / f"{src.stem}_{tag.hexdigest()[:12]}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-Xptxas",
               "-v", "-shared", "-o", str(so), str(src)]
        jobs.append((p, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for p, so, proc in jobs:
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on {p}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, symbol)
        sig = _build.SIGNATURES[symbol]
        decl = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)",
                         Path(p).read_text())
        argc = len([a for a in decl.group(1).split(",") if a.strip()])
        if argc == len(sig) - 1:
            # an entry point from before its last int argument (the
            # fused round's ring depth): the call drops that argument
            fn.argtypes = sig[:-2] + sig[-1:]
            setattr(lib, symbol, lambda *a, _fn=fn: _fn(*a[:-2], a[-1]))
        else:
            check(argc == len(sig), f"{p}: {symbol} takes {argc} arguments")
            fn.argtypes = sig
        fn.restype = ctypes.c_int
        # the error strings live in selective_copy.cu, not in this build
        lib.libra_error_string = lambda rc: b"see cudaError_t"
        libs[p] = lib
        ptxas, run_kernel = [], False
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                run_kernel = re.search(instance, ln) is not None
            elif run_kernel and ("Used" in ln or "spill" in ln):
                ptxas.append(ln.strip())
        emit({"ab_build": p, "ptxas": ptxas,
              "sass": sass_mix(so, nvcc, instance)})
    emit({"ab_build_seconds": time.perf_counter() - t0})
    return libs


def sass_mix(so: Path, nvcc: str, instance: str):
    """The 20 commonest opcodes (with their first modifier) in the code of
    the kernel whose mangled name matches ``instance`` in a built library
    (``cuobjdump``): a static count, and the loops are unrolled."""
    import re

    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(so)], capture_output=True, text=True).stdout
    inside, counts = False, {}
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9.]*)")
    for ln in dump.splitlines():
        if "Function :" in ln:
            inside = re.search(instance, ln) is not None
            continue
        m = op.search(ln) if inside else None
        if m:
            key = ".".join(m.group(1).split(".")[:2])
            counts[key] = counts.get(key, 0) + 1
    return sorted(counts.items(), key=lambda kv: -kv[1])[:20]


def ab_parity(libs, _build, run) -> dict:
    """``run()`` (a parity phase) through each build, the wrapper's library
    swapped; a build that fails is reported and timed all the same."""
    passed = {}
    for p, lib in libs.items():
        _build._LIB = lib
        emit({"ab_variant": p})
        try:
            run()
            passed[p] = True
        except Exception as exc:  # reported; the other builds still run
            emit({"ab_variant": p, "failed": str(exc)})
            passed[p] = False
    return passed


def ab_times(libs, _build, fn, torch, clean_l2: bool = False) -> dict:
    """Median device time of ``fn()`` through each build, in turns (A B
    ... B A, twice), each a median of ``TIMED_RUNS`` launches; a build
    whose launch fails is reported and left out."""
    def through(lib):
        _build._LIB = lib
        return fn()
    times = {p: [] for p in libs}
    for _ in range(2):
        for p in list(libs) + list(libs)[::-1]:
            if p not in times:
                continue
            try:
                times[p].append(time_ms(lambda: through(libs[p]), torch,
                                        clean_l2=clean_l2))
            except RuntimeError as exc:
                emit({"ab_variant": p, "timing_failed": str(exc)})
                del times[p]
    return times


def tf32_bounds(nbytes, flops, torch) -> dict:
    """The split-TF32 and float32-FMA bounds of a tensor-core kernel."""
    trate = peak_ops_per_s(torch, TF32_OPS_PER_SM_CLOCK)
    frate = peak_ops_per_s(torch, FP32_OPS_PER_SM_CLOCK)
    return {"bound_ms": bound(nbytes, TF32_SPLIT_PASSES * flops, trate)[0],
            "fp32_fma_bound_ms": bound(nbytes, flops, frate)[0]}


def ab_report(phase, label, bounds, times, passed, torch, **extra) -> int:
    """Print one A/B phase line: each build's median time beside the
    function's ``bounds``; 0 if every build passed its parity phase."""
    emit({"phase": phase, "variant": label, "card": card_line(torch),
          "runs_per_time": TIMED_RUNS, **bounds, **extra,
          "ms": {p: statistics.median(t) for p, t in times.items()},
          "ms_each": times, "parity": passed})
    return 0 if all(passed.values()) else 1


#: phi4-mini-3.8b's per-layer projections (name, K, N), which the prefill
#: takes through ``ops.linear_f32``, and hymba's ragged widths
LINEAR_SHAPES = (("wq", 3072, 3072), ("wk", 3072, 1024), ("wv", 3072, 1024),
                 ("wo", 3072, 3072), ("w_gate", 3072, 8192),
                 ("w_up", 3072, 8192), ("w_down", 8192, 3072))
LINEAR_RAGGED = (("hymba_wq", 1600, 1600), ("hymba_wk", 1600, 320))
LINEAR_ROWS = 4096


def linear(dev, torch, ops, _build) -> int:
    """The prefill projections' kernel alone: built with the ``ptxas``
    report, then at each of ``LINEAR_SHAPES`` with ``LINEAR_ROWS`` rows
    (x ~ N(0, 1), w ~ N(0, 1 / K), as the benchmark draws them) its error
    from a float64 product beside ``torch.matmul``'s (the plain version,
    which is also the library call), and both medians under both flushes
    beside the split-TF32 bound (three TF32 products at the card's TF32
    rate) and the float32-FMA one; the ragged shapes for their error."""
    t0 = time.perf_counter()
    _build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    gen = torch.Generator(device=dev)
    gen.manual_seed(35)
    rows_out, ok = [], True
    for name, k, n in LINEAR_SHAPES + LINEAR_RAGGED:
        x = torch.randn((LINEAR_ROWS, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        want = x.double() @ w.double()
        err = (ops.linear_f32(x, w).double() - want).abs().max().item()
        lib_err = (torch.matmul(x, w).double() - want).abs().max().item()
        row = {"shape": name, "rows": LINEAR_ROWS, "k": k, "n": n,
               "max_abs_err": err, "matmul_max_abs_err": lib_err}
        ok = ok and err <= 4 * lib_err
        if (name, k, n) in LINEAR_SHAPES:
            flops = 2 * LINEAR_ROWS * k * n
            nbytes = 4 * (LINEAR_ROWS * k + k * n + LINEAR_ROWS * n)
            kern = both_flushes(lambda: ops.linear_f32(x, w, impl="cuda"),
                                torch)
            lib = both_flushes(lambda: torch.matmul(x, w), torch)
            row.update(tf32_bounds(nbytes, flops, torch), ms=kern,
                       library_ms=lib,
                       tflops=flops / kern["dirty_l2"] / 1e9,
                       library_tflops=flops / lib["dirty_l2"] / 1e9)
        emit(row)
        rows_out.append(row)
        del x, w, want
    emit({"phase": "linear", "card": card_line(torch),
          "runs_per_time": TIMED_RUNS, "within_4x_matmul": ok,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return 0 if ok else 1


def mlstm_ab(paths, dev, torch, np, ops, _build, serve=False) -> int:
    """Phase 7 and the run-shape timing through each build of the mLSTM
    scan; with ``serve``, phase 8 too."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mlstm_scan as kmlstm

    libs = build_variants(paths, _build, "libra_mlstm_scan",
                          "mlstm_scan_kernelILi64ELi512E")
    xs = XlstmSize()

    def run():
        mlstm_parity(xs, get_config(xs.arch), dev, torch, ops)
        if serve:
            xlstm_serve(xs, dev, torch, np, kmlstm)
    passed = ab_parity(libs, _build, run)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    mc, label, flops, nbytes = mlstm_timing_case(xs, gen, dev, torch)
    times = ab_times(libs, _build, lambda: ops.mlstm_scan(
        *mc, chunk=xs.chunk, impl="cuda", return_state=True), torch)
    return ab_report("mlstm_ab", label, tf32_bounds(nbytes, flops, torch),
                     times, passed, torch)


def flash_ab(paths, dev, torch, ops, _build) -> int:
    """Phase 5's flash_attention cases and the prefill-layer timing through
    each build of the flash attention kernel, and SDPA's time beside them."""
    from repro_torch.configs import get_config

    libs = build_variants(paths, _build, "libra_flash_attention",
                          "flash_attention_kernelILi128E")
    ss = ServeSize()
    cfg = get_config(ss.arch)
    passed = ab_parity(libs, _build, lambda: attn_parity(
        ss, cfg, dev, torch, ops, kernels=("flash_attention",)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    (fq, fk, fv), label, flops, nbytes = flash_timing_case(ss, cfg, gen, dev,
                                                           torch)
    times = ab_times(libs, _build, lambda: ops.flash_attention(
        fq, fk, fv, impl="cuda"), torch)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return ab_report("flash_ab", label, tf32_bounds(nbytes, flops, torch),
                     times, passed, torch,
                     library_ms=time_ms(lambda: sdpa(
                         fq, fk, fv, is_causal=True, enable_gqa=True), torch))


def paged_ab(paths, dev, torch, ops, _build) -> int:
    """Phase 5's paged_attention cases and the decode-layer timing through
    each build of the paged attention kernel, beside the bytes bound of
    phase 9's row and each build's achieved rate."""
    from repro_torch.configs import get_config

    libs = build_variants(paths, _build, "libra_paged_attention",
                          r"paged_attention_kernelILi128E(?:Li3E)?EEv")
    ss = ServeSize()
    cfg = get_config(ss.arch)
    passed = ab_parity(libs, _build, lambda: attn_parity(
        ss, cfg, dev, torch, ops, kernels=("paged_attention",)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    pc, label, flops, nbytes = paged_timing_case(ss, cfg, gen, dev, torch)
    # the same bytes read by one PyTorch reduction, as a yardstick of the
    # rate a plain read reaches under each flush
    flat = torch.randn(nbytes // 4, device=dev)
    return ab_bytes_report(
        "paged_ab", label, libs, _build,
        lambda: ops.paged_attention(*pc, impl="cuda"), torch, passed,
        nbytes, flops, peak_ops_per_s(torch, FP32_OPS_PER_SM_CLOCK),
        same_bytes_sum_ms=both_flushes(flat.sum, torch))


def ab_bytes_report(phase, label, libs, _build, fn, torch, passed, nbytes,
                    ops_, ops_rate, **extra) -> int:
    """Time ``fn()`` through each build in turns under both flushes and
    print one A/B line beside the bound of these bytes and operations:
    each build's TB/s and share of the bound."""
    times = ab_times(libs, _build, fn, torch)
    clean = ab_times(libs, _build, fn, torch, clean_l2=True)
    b_ms, b_by, _ = bound(nbytes, ops_, ops_rate)
    ms = {p: statistics.median(t) for p, t in times.items()}
    ms_clean = {p: statistics.median(t) for p, t in clean.items()}
    return ab_report(phase, label,
                     {"bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes},
                     times, passed, torch,
                     tb_per_s={p: nbytes / t / 1e9 for p, t in ms.items()},
                     share_of_bound={p: b_ms / t for p, t in ms.items()},
                     ms_clean_l2=ms_clean,
                     share_of_bound_clean_l2={p: b_ms / t
                                              for p, t in ms_clean.items()},
                     **extra)


def gather_ab(paths, dev, torch, np, ops, tt, _build) -> int:
    """Phase 1's selective_gather cases and the deployment's gather timing
    (plain and with the TX keystream) through each build of the gather
    kernel, beside ``index_select`` of its rows, a ``copy_`` of as many
    bytes as it writes and a kernel that returns at once."""
    libs = build_variants(paths, _build, "libra_selective_gather",
                          "selective_gather")
    size = Size()
    passed = ab_parity(libs, _build, lambda: parity(
        size, dev, torch, np, ops, tt, kernels=("selective_gather",)))
    g, rows_idx, n_g, nbytes = gather_timing_case(
        size, np.random.default_rng(29), dev, np, tt)
    src = torch.empty_like(g["ks"])
    dst = torch.empty_like(src)
    yard = dict(library_ms=both_flushes(
                    lambda: torch.index_select(g["pool"], 0, rows_idx),
                    torch),
                same_bytes_copy_ms=both_flushes(lambda: dst.copy_(src),
                                                torch),
                empty_kernel_ms=empty_kernel_ms(torch))
    rate = peak_ops_per_s(torch, INT32_OPS_PER_SM_CLOCK)
    rc = 0
    for crypto in (False, True):
        ks = g["ks"] if crypto else None
        rc |= ab_bytes_report(
            "gather_ab", "ks" if crypto else "plain", libs, _build,
            lambda: ops.selective_gather(g["pool"], g["tables"],
                                         g["lengths"], impl="cuda",
                                         keystream=ks),
            torch, passed, nbytes(crypto), n_g * crypto, rate, **yard)
    return rc


def fused_ab(paths, dev, torch, np, ops, tt, _build) -> int:
    """Phase 1's fused_round cases and the deployment's fused-round timing
    (plain + policy, both keystreams + policy, and plain without the
    policy table) at each ring depth through each build of the fused
    round kernel (an entry point without the depth argument runs every
    depth alike), beside a kernel that returns at once."""
    libs = build_variants(paths, _build, "libra_fused_round",
                          "fused_round")
    size = Size()
    passed = ab_parity(libs, _build, lambda: parity(
        size, dev, torch, np, ops, tt, kernels=("fused_round",)))
    f, fvars = fused_timing_case(size, np.random.default_rng(29), dev, np,
                                 tt)
    kw, nbytes, nops = fvars["plain+policy"]
    # without the table: the verdict's table, tokens and output drop out
    fvars["plain, no policy"] = ({}, nbytes - 4 * (
        3 * f["cond_off"].numel() + policy_refs(
            f["cond_off"].cpu().numpy(), f["meta_len"].cpu().numpy(),
            size.meta_max, (f["total_len"] - f["meta_len"]).cpu().numpy(),
            size.page, np) + size.channels), 0)
    rate = peak_ops_per_s(torch, INT32_OPS_PER_SM_CLOCK)
    floor = empty_kernel_ms(torch)
    rc = 0
    for vname, (kw, nbytes, nops) in fvars.items():
        for depth in PROFILE_DEPTHS:
            rc |= ab_bytes_report(
                "fused_ab", f"{vname} n_buffers={depth}", libs, _build,
                lambda: ops.fused_round(f["stream"], f["meta_len"],
                                        f["total_len"], f["pool"],
                                        f["tables"], meta_max=size.meta_max,
                                        impl="cuda", n_buffers=depth, **kw),
                torch, passed, nbytes, nops, rate, empty_kernel_ms=floor)
    return rc


def copy_ab(paths, dev, torch, np, ops, tt, _build) -> int:
    """Phase 1's selective_copy cases and the deployment's RX copy timing
    (plain and with the keystream) through each build of the selective
    copy kernel, beside a ``copy_`` of as many bytes as it writes and a
    kernel that returns at once."""
    libs = build_variants(paths, _build, "libra_selective_copy",
                          r"selective_copy_kernel(?:ILi1EEEv|E)PKi")
    size = Size()
    passed = ab_parity(libs, _build, lambda: parity(
        size, dev, torch, np, ops, tt, kernels=("selective_copy",)))
    c, writes, cost = copy_timing_case(size, np.random.default_rng(29), dev,
                                       np, tt)
    src = torch.zeros(writes, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    yard = dict(same_bytes_copy_ms=both_flushes(lambda: dst.copy_(src),
                                                torch),
                empty_kernel_ms=empty_kernel_ms(torch))
    rate = peak_ops_per_s(torch, INT32_OPS_PER_SM_CLOCK)
    rc = 0
    for crypto in (False, True):
        ks = c["keystream"] if crypto else None
        rc |= ab_bytes_report(
            "copy_ab", "ks" if crypto else "plain", libs, _build,
            lambda: ops.selective_copy(c["stream"], c["meta_len"],
                                       c["total_len"], c["pool"],
                                       c["tables"], meta_max=size.meta_max,
                                       impl="cuda", keystream=ks),
            torch, passed, *cost(crypto), rate, **yard)
    return rc


def policy_ab(paths, dev, torch, np, ops, tt, _build) -> int:
    """Phase 1's policy_match cases and the deployment's policy timing
    (payload window on, plain and with the keystream) through each build
    of the policy match kernel, beside a kernel that returns at once."""
    libs = build_variants(paths, _build, "libra_policy_match",
                          "policy_match_kernel")
    size = Size()
    passed = ab_parity(libs, _build, lambda: parity(
        size, dev, torch, np, ops, tt, kernels=("policy_match",)))
    p, cost = policy_timing_case(size, np.random.default_rng(29), dev, np,
                                 tt)
    floor = empty_kernel_ms(torch)
    rate = peak_ops_per_s(torch, INT32_OPS_PER_SM_CLOCK)
    rc = 0
    for crypto in (False, True):
        ks = p["ks"] if crypto else None
        rc |= ab_bytes_report(
            "policy_ab", "ks" if crypto else "plain", libs, _build,
            lambda: ops.policy_match(p["meta"], p["ml"], p["off"], p["lo"],
                                     p["hi"], impl="cuda", keystream=ks,
                                     payload=p["pw"], payload_len=p["pln"]),
            torch, passed, *cost(crypto), rate, empty_kernel_ms=floor)
    return rc


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 20: training
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainSize:
    """A training run of phase 20 (see PERF.md, Cells)."""
    arch: str
    #: layers trained; 0 keeps the config's depth
    layers: int = 0
    batch: int = 8
    seq: int = 512
    remat: str = "none"
    steps: int = 30
    seed: int = 0

    def config(self):
        """The arch's published config, its depth cut to ``layers``."""
        return cut_config(self.arch, self.layers)


#: (a) the model the JAX package's trainer, launcher and examples train,
#: at full size (12 layers, d_model 768, 162 M parameters)
TRAIN_PROXY = TrainSize(arch="libra-proxy-125m")
#: (b) phi4-mini at full width, 16 of its 32 layers: 2 x 2048 positions,
#: so every layer attends through blockwise_attention and its backward
TRAIN_PHI4 = TrainSize(arch="phi4-mini-3.8b", layers=16, batch=2, seq=2048,
                       remat="full", steps=3)
TRAIN_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=200)
#: the fault-tolerance twin of (a): save at this step, train on this many
TRAIN_SAVE_AT = 10
TRAIN_RESUME_STEPS = 5
#: a resumed run against the continued run (tests/test_training_ft.py)
RESUME_TOL = 1e-5
#: the mean loss of the last 5 steps below the first 5's by more than this
LOSS_DROP = 0.5
#: (c) blockwise_attention's backward against autograd through
#: dense_attention: the bars of tests/test_torch_blockwise.py (TOL,
#: BF16_VS_DENSE_REL), at phi4-mini's head shapes
BLOCKWISE_F32_TOL = dict(atol=1e-5, rtol=1e-5)
BLOCKWISE_BF16_REL = 1e-2
#: (b, hq, hkv, hd) of phi4-mini's attention at (b)'s batch
BLOCKWISE_HEADS = (2, 24, 8, 128)
#: name -> (sq, skv, causal, window)
BLOCKWISE_CASES = {"causal": (2048, 2048, True, 0),
                   "window-1024": (2048, 2048, True, 1024),
                   "noncausal-1500x1536": (1500, 1536, False, 0)}
#: (c) loss_fn and its gradients on the card against the CPU, both in
#: bfloat16, from the card's own readings (NVIDIA H100 80GB HBM3, 700 W:
#: the loss up to 2.1e-4 apart, a leaf's gradient up to 9.0e-3 by
#: relative norm, all leaves together up to 6.9e-3), about three times
#: the worst of them
CARD_LOSS_TOL = 1e-3
CARD_GRAD_TOL = 3e-2
CARD_GRAD_GLOBAL_TOL = 2e-2
#: (c) the control: the same card run from parameters rounded to this
#: dtype must break the bars above (on the CPU it lies 0.10-0.90 from the
#: exact gradients per leaf)
CARD_CONTROL_DTYPE = "float8_e4m3fn"
#: (c) the exact-resume twin at reduced configs: batch x positions (two
#: mLSTM chunks of 64)
RESUME_REDUCED_SHAPE = (2, 128)
#: the labels of a training step's split, in attribution order: a device
#: event goes to the first label whose host range holds its launch, so a
#: layer's kernels in the first forward count as "forward" and only its
#: rerun in the backward (remat) as "recompute"
TRAIN_SPLIT = ("blockwise.backward", "forward", "recompute", "head",
               "adamw", "backward")


def train_batch(ts: TrainSize, cfg, dev, torch):
    """The next batch of a fresh ``SyntheticCorpus(seed=0)`` pipeline at
    ``ts``'s shape, on the card."""
    from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus

    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=0),
                        batch=ts.batch, seq_len=ts.seq)
    b = pipe.next_batch()
    return {k: torch.tensor(b[k], device=dev) for k in ("tokens", "labels")}


def train_split(trainer, batch, torch) -> dict:
    """Device time of one training step by part (:func:`labelled_split`),
    as ``Trainer`` computes it but with the head's backward run first, on
    its own (to a detached copy of the final hidden state), then the
    body's: the same products, so that each part has a host range.
    ``forward`` is the body's forward; ``recompute`` its rerun under
    ``remat``; ``blockwise.backward`` the custom backward of
    ``blockwise_attention``; ``backward`` the other products and
    elementwise work of the body's backward; ``head`` the head's product,
    the loss and their backward; ``adamw`` the update (global norm,
    moments, parameters)."""
    from torch.profiler import record_function

    from repro_torch.models import attention as attn
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.training.optimizer import adamw_update

    model = trainer.model
    check(model.cfg.family == "dense", "the split runs the dense family")

    def step():
        t0 = time.perf_counter()
        params = trainer.params
        with record_function("forward"):
            hidden, aux = model.forward(params, batch["tokens"],
                                        remat=trainer.remat)
        with record_function("head"):
            h = hidden.detach().requires_grad_()
            total, _ = model.head_loss(params, h, batch["labels"], aux)
            total.backward()
        with record_function("backward"):
            torch.autograd.backward(hidden, h.grad)
        with record_function("adamw"), torch.no_grad():
            trainer.params, trainer.opt_state, _ = adamw_update(
                trainer.opt_cfg, params, tree_map(lambda p: p.grad, params),
                trainer.opt_state)
        for p in tree_leaves(params):
            p.grad = None
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # the window opens after a step of its own (see labelled_split)
    out = labelled_split([(attn._Blockwise, "backward", "blockwise.backward"),
                          (model, "_train_layer", "recompute")], step,
                         batch["tokens"].device, torch, warmup=step,
                         labels=TRAIN_SPLIT)
    out["share_of_device"] = {k: v / out["device_ms"]
                              for k, v in out["device_ms_by_part"].items()}
    return out


def train_stats(ts: TrainSize, hist, torch) -> dict:
    """Step times of a run's history (the first step, which allocates, set
    apart), tokens a second at the median, peak device memory."""
    steps = [h["time"] for h in hist]
    med = statistics.median(steps[1:] if len(steps) > 1 else steps)
    return {"steps": len(steps), "first_step_ms": steps[0] * 1e3,
            "step_ms": [t * 1e3 for t in steps],
            "median_step_ms": med * 1e3,
            "tokens_per_s": ts.batch * ts.seq / med,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist]}


def new_trainer(ts: TrainSize, cfg, dev, ckpt_dir=None, mesh=None):
    from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer

    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=0),
                        batch=ts.batch, seq_len=ts.seq)
    return Trainer(build_model(cfg), AdamWConfig(**TRAIN_OPT), pipe,
                   checkpoint_dir=ckpt_dir, checkpoint_every=10 ** 6,
                   remat=ts.remat, seed=ts.seed, device=dev, mesh=mesh)


def resume_twin(ts: TrainSize, cfg, dev, ck: str, hist: list):
    """A fresh ``Trainer`` resumes the checkpoint at ``TRAIN_SAVE_AT`` in
    ``ck`` and trains ``TRAIN_RESUME_STEPS`` steps; each loss must be
    within ``RESUME_TOL`` of the continued run's (``hist``, its history).
    Returns the resumed trainer and the readings."""
    t2 = new_trainer(ts, cfg, dev, ck)
    check(t2.resume() and t2.step == TRAIN_SAVE_AT,
          f"{ts.arch}: no checkpoint at step {TRAIN_SAVE_AT} to resume")
    resumed = [h["loss"] for h in t2.train(TRAIN_RESUME_STEPS)]
    continued = [h["loss"] for h in
                 hist[TRAIN_SAVE_AT:TRAIN_SAVE_AT + TRAIN_RESUME_STEPS]]
    err = max(abs(a - b) for a, b in zip(resumed, continued))
    check(err < RESUME_TOL,
          f"{ts.arch}: the resumed run's losses {resumed} differ from "
          f"the continued run's {continued} by {err}")
    return t2, {"save_at": TRAIN_SAVE_AT, "resumed": resumed,
                "continued": continued, "max_abs_err": err,
                "tol": RESUME_TOL}


def resume_reduced(dev) -> list:
    """(c): the exact-resume twin of (a) at the reduced config of every
    arch whose ``loss_fn`` takes tokens alone, at
    ``RESUME_REDUCED_SHAPE``."""
    import tempfile

    from repro_torch.configs import ARCHS, get_reduced

    b, seq = RESUME_REDUCED_SHAPE
    out = []
    for arch in ARCHS:
        cfg = get_reduced(arch)
        if cfg.family in ("vlm", "encdec"):
            continue
        ts = TrainSize(arch=arch, batch=b, seq=seq)
        with tempfile.TemporaryDirectory() as ck:
            t = new_trainer(ts, cfg, dev, ck)
            t.train(TRAIN_SAVE_AT)
            t.save(blocking=True)
            t.train(TRAIN_RESUME_STEPS)
            _t2, resume = resume_twin(ts, cfg, dev, ck, t.history)
        out.append({"arch": arch, "family": cfg.family, "batch": [b, seq],
                    **resume})
    return out


def train_proxy(ts: TrainSize, dev, torch) -> dict:
    """(a): ``ts.steps`` steps of ``Trainer`` on ``SyntheticCorpus(seed=0)``
    with a checkpoint at ``TRAIN_SAVE_AT``; the loss must fall by more
    than ``LOSS_DROP``. Then a fresh ``Trainer`` resumes that checkpoint
    and trains ``TRAIN_RESUME_STEPS`` steps, each loss within
    ``RESUME_TOL`` of the continued run's; then a simulated preemption
    writes its final checkpoint at the step it stopped. Last, a profiled
    step."""
    import tempfile

    cfg = ts.config()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ck:
        t = new_trainer(ts, cfg, dev, ck)
        t.train(TRAIN_SAVE_AT)
        t.save(blocking=True)
        t.train(ts.steps - TRAIN_SAVE_AT)
        hist = t.history
        stats = train_stats(ts, hist, torch)
        first = statistics.mean(h["loss"] for h in hist[:5])
        last = statistics.mean(h["loss"] for h in hist[-5:])
        check(last < first - LOSS_DROP,
              f"{ts.arch}: the loss fell from {first} to {last}, not by "
              f"more than {LOSS_DROP}")
        t2, resume = resume_twin(ts, cfg, dev, ck, hist)
        t2._preempted = True                 # a simulated SIGTERM
        t2.train(3)
        stop = TRAIN_SAVE_AT + TRAIN_RESUME_STEPS
        check(t2.step == stop and t2.ckpt.latest_step() == stop,
              f"{ts.arch}: the preempted run stopped at {t2.step} with its "
              f"last checkpoint at {t2.ckpt.latest_step()}, not {stop}")
        del t2
        split = train_split(t, train_batch(ts, cfg, dev, torch), torch)
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": ts.arch, "params": cfg.param_count(),
            "batch": [ts.batch, ts.seq], "remat": ts.remat, **stats,
            "first5_mean_loss": first, "last5_mean_loss": last,
            "resume": resume,
            "preempted_at": stop, "split": split}


def train_big(ts: TrainSize, dev, torch) -> dict:
    """(b): ``ts.steps`` steps of ``Trainer`` on phi4-mini at full width,
    ``remat="full"``, every layer through ``blockwise_attention``: finite
    losses, a positive gradient norm; then a profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn

    cfg = ts.config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t = new_trainer(ts, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    calls = []
    orig = attn.blockwise_attention

    def counted(*args, **kw):
        calls.append(args[0].shape[1])
        return orig(*args, **kw)
    attn.blockwise_attention = counted
    try:
        hist = t.train(ts.steps)
    finally:
        attn.blockwise_attention = orig
    stats = train_stats(ts, hist, torch)
    check(all(math.isfinite(x) for x in stats["losses"]) and
          all(g > 0 and math.isfinite(g) for g in stats["grad_norms"]),
          f"{ts.arch}: losses {stats['losses']}, gradient norms "
          f"{stats['grad_norms']}")
    # a layer's forward calls it once, its rerun under remat once more
    check(len(calls) == 2 * ts.steps * cfg.num_layers,
          f"{ts.arch}: blockwise_attention ran {len(calls)} times, not "
          f"{2 * ts.steps * cfg.num_layers}")
    batch = train_batch(ts, cfg, dev, torch)
    labelled = int((batch["labels"] >= 0).sum())
    split = train_split(t, batch, torch)
    check(split["device_ms_by_part"]["blockwise.backward"] > 0 and
          split["device_ms_by_part"]["recompute"] > 0 and
          split["device_ms_by_part"]["adamw"] > 0,
          f"{ts.arch}: the split shows no blockwise backward, recompute or "
          f"AdamW: {split}")
    n = cfg.param_count()
    tokens = ts.batch * ts.seq
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": ts.arch, "params": n, "param_gb": n * 4 / 1e9,
            "state_gb": n * 16 / 1e9, "param_init_s": init_s,
            "layers": cfg.num_layers,
            "reduced": {"num_layers": [ts.layers,
                                       get_config(ts.arch).num_layers]},
            "batch": [ts.batch, ts.seq], "labelled_tokens": labelled,
            "remat": ts.remat, **stats,
            "flops_6nd": 6 * n * tokens, "flops_8nd_remat": 8 * n * tokens,
            "tflops_8nd_per_s": 8 * n * tokens
            / (stats["median_step_ms"] / 1e3) / 1e12,
            "blockwise_calls": len(calls), "split": split}


def blockwise_card(dev, torch) -> list:
    """(c): ``blockwise_attention``'s output and custom backward against
    autograd through ``dense_attention`` at phi4-mini's head shapes, in
    float32 and bfloat16."""
    from repro_torch.models import attention as attn

    b, hq, hkv, hd = BLOCKWISE_HEADS
    out = []
    for name, (sq, skv, causal, window) in BLOCKWISE_CASES.items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(20)
        q = torch.randn(b, sq, hq, hd, generator=gen, device=dev)
        k, v = (torch.randn(b, skv, hkv, hd, generator=gen, device=dev)
                for _ in range(2))
        do = torch.randn(b, sq, hq, hd, generator=gen, device=dev)
        pq = torch.arange(sq, device=dev).expand(b, sq)
        pk = torch.arange(skv, device=dev).expand(b, skv)
        check(attn.blockwise_kv_pad(sq, skv) == 0 or causal,
              f"{name}: would attend to padded zero keys")
        for dtype in (torch.float32, torch.bfloat16):
            res = {}
            for fn_name, fn in (("blockwise", attn.blockwise_attention),
                                ("dense", attn.dense_attention)):
                xs = [x.detach().to(dtype).requires_grad_()
                      for x in (q, k, v)]
                o = fn(*xs, pq, pk, causal=causal, window=window)
                o.backward(do.to(dtype))
                res[fn_name] = [o.detach()] + [x.grad for x in xs]
                del xs, o
            row = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": [b, sq, skv, hq, hkv, hd], "window": window}
            for label, got, want in zip(("out", "dq", "dk", "dv"),
                                        res["blockwise"], res["dense"]):
                got, want = got.float(), want.float()
                rel = float((got - want).norm() / want.norm())
                row[label] = {"max_abs_err": float((got - want).abs().max()),
                              "rel_norm": rel}
                if dtype == torch.float32:
                    ok = torch.allclose(got, want, **BLOCKWISE_F32_TOL)
                else:
                    ok = rel < BLOCKWISE_BF16_REL
                check(ok, f"blockwise {name} {dtype} {label}: {row[label]}")
            out.append(row)
            del res
        torch.cuda.empty_cache()
    return out


class RouterReplay:
    """The card's expert choices, replayed on the CPU. A bfloat16 router
    logit may tie or near-tie at the top-k boundary (reduced qwen2-moe
    ties exactly in its second layer), and the two devices may then pick
    other experts: a discrete difference, not a numerical one. Inside
    ``record()`` every ``moe.router_topk`` call keeps its ids; inside
    ``replay()`` each call takes the recorded ids in order, with the
    gates the router's softmax gives them (normalised as
    ``router_topk`` does), and counts the rows whose own choice
    differed."""

    def __init__(self):
        self.ids, self.flipped_rows, self.calls = [], 0, 0

    @contextlib.contextmanager
    def _patched(self, fn):
        from repro_torch.models import moe

        orig = moe.router_topk
        moe.router_topk = lambda logits, cfg: fn(orig, logits, cfg)
        try:
            yield self
        finally:
            moe.router_topk = orig

    def record(self):
        def rec(orig, logits, cfg):
            gates, ids = orig(logits, cfg)
            self.ids.append(ids.detach().cpu())
            return gates, ids
        return self._patched(rec)

    def replay(self):
        def rep(orig, logits, cfg):
            import torch

            ids = self.ids[self.calls].to(logits.device)
            self.calls += 1
            _own_gates, own = orig(logits, cfg)
            self.flipped_rows += int((own.sort(-1).values
                                      != ids.sort(-1).values).any(-1).sum())
            pad = torch.arange(cfg.padded_experts,
                               device=logits.device) >= cfg.num_experts
            probs = torch.softmax(logits.masked_fill(pad, -1e30).float(), -1)
            gates = probs.gather(-1, ids)
            return gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), ids
        return self._patched(rep)


def grad_distance(got, want) -> dict:
    """Losses and gradients ``(loss, [leaf gradients])`` of two runs: the
    loss apart, the largest relative norm of a leaf's difference and that
    of all leaves together."""
    import torch

    (l_got, g_got), (l_want, g_want) = got, want
    rels = [float((a - b).norm() / b.norm().clamp(min=1e-30))
            for a, b in zip(g_got, g_want)]
    glob = float(torch.cat([(a - b).ravel() for a, b in
                            zip(g_got, g_want)]).norm()
                 / torch.cat([b.ravel() for b in g_want]).norm())
    return {"loss_abs_err": abs(l_got - l_want), "grad_rel_max": max(rels),
            "grad_rel_global": glob}


def within_card_bars(d: dict) -> bool:
    return (d["loss_abs_err"] < CARD_LOSS_TOL
            and d["grad_rel_max"] < CARD_GRAD_TOL
            and d["grad_rel_global"] < CARD_GRAD_GLOBAL_TOL)


def grads_card(dev, torch, np) -> list:
    """(c): ``loss_fn`` (bfloat16, ``remat="none"``) and its gradients on
    the card against the same on the CPU, from the same parameters and
    batch, for the reduced config of every arch and of libra-proxy. Under
    ``moe`` the CPU run takes the card's expert choices
    (:class:`RouterReplay`), and the rows whose choice that changed are
    counted. A control run on the card from the parameters rounded to
    ``CARD_CONTROL_DTYPE`` (with its own expert choices) must break the
    bars."""
    from repro_torch.configs import ARCHS, get_reduced
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.registry import build_model

    control_dtype = getattr(torch, CARD_CONTROL_DTYPE)
    out = []
    for arch in ARCHS + ["libra-proxy-125m"]:
        cfg = get_reduced(arch)
        model = build_model(cfg)
        rng = np.random.default_rng(0)
        batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (2, 16)),
                                 dtype=torch.int32)
                 for k in ("tokens", "labels")}
        if cfg.family == "vlm":
            batch["img_embeds"] = torch.tensor(rng.standard_normal(
                (2, cfg.img_tokens, cfg.d_model))).to(torch.bfloat16)
        if cfg.family == "encdec":
            batch["frames"] = torch.tensor(rng.standard_normal(
                (2, cfg.enc_frames, cfg.d_model))).to(torch.bfloat16)
        host = model.init_params(0, device="cpu")
        rounded = tree_map(lambda p: p.to(control_dtype).float(), host)
        runs = {}
        router = RouterReplay()
        for label, where, src, ctx in (
                ("card", dev, host, router.record()),
                ("cpu", "cpu", host, router.replay()),
                ("control", dev, rounded, contextlib.nullcontext())):
            params = tree_map(lambda p: p.detach().to(where)
                              .requires_grad_(), src)
            with ctx:
                total, _ = model.loss_fn(
                    params, {k: v.to(where) for k, v in batch.items()},
                    remat="none")
            total.backward()
            runs[label] = (float(total.detach()), [
                p.grad.float().cpu() if p.grad is not None
                else torch.zeros_like(p, device="cpu")
                for p in tree_leaves(params)])
        row = {"arch": arch, "loss_cpu": runs["cpu"][0],
               "loss_card": runs["card"][0],
               **grad_distance(runs["card"], runs["cpu"]),
               "router_calls": router.calls,
               "rows_routed_otherwise_on_cpu": router.flipped_rows,
               "control": {"dtype": CARD_CONTROL_DTYPE,
                           **grad_distance(runs["control"], runs["cpu"])}}
        check(within_card_bars(row) and
              all(torch.isfinite(g).all() for g in runs["card"][1]),
              f"{arch}: loss_fn on the card differs from the CPU: {row}")
        check(not within_card_bars(row["control"]),
              f"{arch}: the {CARD_CONTROL_DTYPE} control passes the bars: "
              f"{row['control']}")
        out.append(row)
    return out


def train_phase(dev, torch, np) -> dict:
    """Phase 20: training on the card. (a) ``TRAIN_PROXY``, (b)
    ``TRAIN_PHI4``, (c) the blockwise backward and every reduced config's
    gradients. No kernel of the port is on this path (the reference
    trains through jnp functions): none may launch, and each forward-only
    kernel must refuse an input that requires gradients."""
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import mlstm_scan as kmlstm
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_copy as kern

    counts = (kern.LAUNCHES, kattn.LAUNCHES, kmlstm.LAUNCHES)
    before = [dict(c) for c in counts]
    q = torch.ones((1, 2, 16, 16), device=dev, requires_grad=True)
    try:
        ops.flash_attention(q, q, q, impl="cuda")
    except RuntimeError as exc:
        refused = "forward only" in str(exc)
    else:
        refused = False
    check(refused, "flash_attention took an input that requires grad")
    entry = {"card": card_line(torch)}
    entry["proxy"] = train_proxy(TRAIN_PROXY, dev, torch)
    entry["phi4"] = train_big(TRAIN_PHI4, dev, torch)
    entry["blockwise"] = blockwise_card(dev, torch)
    entry["grads"] = grads_card(dev, torch, np)
    entry["resume_reduced"] = resume_reduced(dev)
    launched = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c
                if c[k] != b[k]}
    check(not launched, f"the training path launched kernels: {launched}")
    emit({"phase": "train", **entry})
    return entry


# ---------------------------------------------------------------------------
# phase 21: the mesh
# ---------------------------------------------------------------------------

#: (a) phi4-mini at full width and depth through the mesh keywords
MESH_SERVE = ServeSize(arch="phi4-mini-3.8b", requests=4, max_batch=4,
                       prompt=256, gen=8, timing_context=264)
#: (b) the trainer resumes a mesh-less checkpoint at this step and trains
#: this many steps on the mesh
MESH_SAVE_AT = 5
MESH_RESUME_STEPS = 3
#: (c) compressed_psum's mean against the exact one, by relative norm (the
#: reference's bar, tests/test_training_ft.py)
COMPRESS_TOL = 2e-2
#: (d) the dry-run cell run on the card's host
MESH_DRYRUN = ("phi4-mini-3.8b", "decode_32k")
#: how long the one-rank NCCL group may wait on a collective
MESH_GROUP_TIMEOUT_S = 60


class MeshRun(DirectRun):
    """:class:`DirectRun` of a ``TransformerLM`` through ``prefill`` /
    ``decode_step``; with a ``mesh``, through their mesh keywords, every
    input a DTensor placed for it (the parameters by the serving rules,
    the pool's pages over every axis, the rest batch over the batch
    axis), each wrapping the tensor it is made from."""

    def __init__(self, ss: ServeSize, model, params, inputs: dict, dev,
                 torch, mesh=None):
        super().__init__(ss, model, params, inputs, dev, torch)
        self.mesh, self.kw, self.pool = mesh, {}, self.kv.pool
        if mesh is None:
            return
        from repro_torch.common.sharding import placements_for
        from repro_torch.models import attention as attn

        b_axis, combine = attn.plan_decode_sharding(ss.max_batch, mesh)
        self.kw = dict(mesh=mesh, batch_axis=b_axis, combine_axes=combine)
        self.bpl = attn.batch_placements(mesh, b_axis)
        self.pool = self._wrap(self.kv.pool, placements_for(
            (None, tuple(mesh.mesh_dim_names)), mesh))

    def _wrap(self, t, placements=None):
        if self.mesh is None:
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.mesh, placements or self.bpl,
                                  run_check=False)

    def _local(self, t):
        return t.full_tensor() if self.mesh is not None else t

    def prefill(self) -> list:
        m, inp, ss = self.model, self.inputs, self.ss
        tables, _pp = self.kv.batch_tables(self.handles, ss.pps)
        tc = self.kv.token_coords(self.handles, ss.prompt)
        self.cur = self._local(m.prefill(
            self.params, *map(self._wrap, (inp["tokens"], inp["text_lens"])),
            self.pool, *map(self._wrap, self._dev(tables, *tc)), **self.kw))
        self.pos = ss.prompt
        return self.cur.tolist()

    def step(self) -> list:
        ss, b = self.ss, self.ss.max_batch
        for h in self.handles:
            self.kv.extend(h, self.pos + 1)
        tables, page_pos = self.kv.batch_tables(self.handles, ss.pps)
        wsh, wsl = self.kv.write_coords(self.handles, [self.pos] * b)
        seq_lens = self.torch.full((b,), self.pos, dtype=self.torch.int32,
                                   device=self.dev)
        self.cur = self._local(self.model.decode_step(
            self.params, *map(self._wrap, (self.cur, seq_lens)), self.pool,
            *map(self._wrap, self._dev(tables, page_pos, wsh, wsl)),
            **self.kw))
        self.pos += 1
        return self.cur.tolist()


def mesh_serve_run(ss: ServeSize, model, params, inputs, dev, torch, kattn,
                   mesh=None) -> tuple:
    """A prefill and ``gen - 1`` steps of :class:`MeshRun`, then a
    profiled step (``labelled_split``: the paged attention and, over a
    mesh, its combine's all-reduces). Both kernels must launch once a
    layer a prefill / step. Returns the readings and the tokens."""
    from repro_torch.models import attention as attn_mod

    layers = model.cfg.num_layers
    run = MeshRun(ss, model, params, inputs, dev, torch, mesh)
    kattn.reset_launches()
    out = [run.prefill()]
    check(dict(kattn.LAUNCHES) == {"flash_attention": layers,
                                   "paged_attention": 0},
          f"mesh={mesh is not None}: prefill launched {dict(kattn.LAUNCHES)}")
    step_s = []
    for _ in range(ss.gen - 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out.append(run.step())
        step_s.append(time.perf_counter() - t)
    launches = dict(kattn.LAUNCHES)
    want = {"flash_attention": layers,
            "paged_attention": layers * (ss.gen - 1)}
    check(launches == want,
          f"mesh={mesh is not None}: the run launched {launches}, not {want}")

    def timed_step():
        t0 = time.perf_counter()
        run.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    split = labelled_split(
        [(attn_mod, "all_reduce", "combine"),
         (attn_mod, "paged_decode_attention", "attention")],
        timed_step, dev, torch, warmup=run.step)
    run.close()
    return ({"step_wall_ms_median": statistics.median(step_s) * 1e3,
             "profiled_step": split, "launches": launches},
            [list(r) for r in zip(*out)])


def mesh_serve(ss: ServeSize, mesh, dev, torch, np, kattn) -> dict:
    """(a): ``ss`` without a mesh and then through the mesh keywords on the
    one-card ``(data=1, model=1)`` mesh, on the same parameters and
    requests: identical tokens."""
    from repro_torch.common.sharding import DEFAULT_RULES, tree_shardings
    from repro_torch.models.layers import tree_map
    from repro_torch.models.registry import build_model
    from torch.distributed.tensor import DTensor

    cfg = ss.config()
    model = build_model(cfg, page_size=ss.page)
    params = model.init_params(ss.seed, device=dev)
    rng = np.random.default_rng(ss.seed)
    inputs = {"tokens": torch.from_numpy(rng.integers(
                  1, cfg.vocab_size - 1, (ss.max_batch, ss.prompt)
              ).astype(np.int32)).to(dev),
              "text_lens": torch.full((ss.max_batch,), ss.prompt,
                                      dtype=torch.int32, device=dev)}
    plain, plain_tokens = mesh_serve_run(ss, model, params, inputs, dev,
                                         torch, kattn)
    rules = dict(DEFAULT_RULES)
    rules["fsdp"] = ()
    placements = tree_shardings(model.abstract_params(), model.param_axes(),
                                mesh, rules)
    dparams = tree_map(lambda p, pl: DTensor.from_local(
        p, mesh, pl, run_check=False), params, placements)
    meshed, mesh_tokens = mesh_serve_run(ss, model, dparams, inputs, dev,
                                         torch, kattn, mesh)
    check(mesh_tokens == plain_tokens,
          "the mesh run's tokens differ from the mesh-less run's")
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": ss.arch, "layers": cfg.num_layers,
            "requests": [ss.max_batch, ss.prompt, ss.gen],
            "tokens_identical": True, "no_mesh": plain, "mesh": meshed}


def mesh_train(mesh, dev, torch) -> dict:
    """(b): a mesh-less ``Trainer`` of ``TRAIN_PROXY`` checkpoints at
    ``MESH_SAVE_AT``; a ``Trainer(mesh=...)`` resumes it onto the mesh's
    placements and its ``MESH_RESUME_STEPS`` losses must be within
    ``RESUME_TOL`` of the continued run's."""
    import tempfile

    from torch.distributed.tensor import DTensor

    ts = TRAIN_PROXY
    cfg = ts.config()
    with tempfile.TemporaryDirectory() as ck:
        t1 = new_trainer(ts, cfg, dev, ck)
        t1.train(MESH_SAVE_AT)
        t1.save(blocking=True)
        continued = [h["loss"] for h in t1.train(MESH_RESUME_STEPS)
                     [-MESH_RESUME_STEPS:]]
        del t1
        t2 = new_trainer(ts, cfg, dev, ck, mesh=mesh)
        check(t2.resume() and t2.step == MESH_SAVE_AT,
              "the mesh trainer found no checkpoint to resume")
        check(isinstance(t2.params["layers"]["wq"], DTensor),
              "the mesh trainer's parameters are not DTensors")
        torch.cuda.synchronize()
        t = time.perf_counter()
        resumed = [h["loss"] for h in t2.train(MESH_RESUME_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    err = max(abs(a - b) for a, b in zip(resumed, continued))
    check(err < RESUME_TOL, f"the mesh trainer's losses {resumed} differ "
                            f"from the continued run's {continued} by {err}")
    del t2
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": ts.arch, "save_at": MESH_SAVE_AT, "resumed": resumed,
            "continued": continued, "max_abs_err": err, "tol": RESUME_TOL,
            "ms_a_step": wall / MESH_RESUME_STEPS * 1e3}


def mesh_compress(dev, torch) -> dict:
    """(c): ``compressed_psum`` of a seeded 4096 x 4096 gradient over the
    one-rank group on the card: the mean within ``COMPRESS_TOL`` of the
    exact one, the residual the quantisation error."""
    from repro_torch.training.optimizer import (
        compressed_psum,
        dequantize_int8,
        quantize_int8,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = {"w": torch.randn((4096, 4096), generator=gen, device=dev)}
    red, err = compressed_psum(g, None, {"w": torch.zeros_like(g["w"])})
    torch.cuda.synchronize()
    rel = float(torch.linalg.vector_norm(red["w"] - g["w"])
                / torch.linalg.vector_norm(g["w"]))
    check(rel < COMPRESS_TOL, f"compressed_psum is {rel} from the exact mean")
    q, scale = quantize_int8(g["w"])
    resid = float((err["w"] - (g["w"] - dequantize_int8(q, scale))).abs()
                  .max())
    check(resid == 0.0 and float(err["w"].abs().max()) > 0,
          f"compressed_psum's residual is not the quantisation error "
          f"({resid})")
    return {"shape": [4096, 4096], "rel_err": rel, "tol": COMPRESS_TOL,
            "residual_max_abs_err": resid}


def mesh_dryrun() -> dict:
    """(d): ``MESH_DRYRUN`` at production size on rank 0 of a 256-rank
    fake group (fake CPU tensors on the card's host), its roofline terms
    on the H100 row."""
    import tempfile

    from repro_torch.launch import dryrun

    arch, shape = MESH_DRYRUN
    with tempfile.TemporaryDirectory() as out:
        t = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, False, out_dir=out)
    check(rec["ok"], f"the dry-run of {arch} {shape} failed: "
                     f"{rec.get('error')}")
    check(rec["hlo"]["flops_per_device"] > 0, "the dry-run counted no FLOPs")
    return {"cell": f"{arch}/{shape}/singlepod", "seconds":
            time.perf_counter() - t, "n_chips": rec["n_chips"],
            "memory": rec["memory"], "counts": rec["hlo"],
            "roofline": rec["roofline"]}


def mesh_phase(dev, torch, np) -> dict:
    """Phase 21: the mesh on the card. A one-rank NCCL group and a
    ``(data=1, model=1)`` ``DeviceMesh`` on ``cuda``: (a) serving through
    the mesh keywords, (b) the trainer's elastic restart onto the mesh,
    (c) ``compressed_psum``; the group is destroyed, then (d) the dry-run
    cell on the fake group. NCCL must start: there is no other backend
    and no mesh-less path to fall back on."""
    import datetime
    import socket

    import torch.distributed as dist

    from repro_torch.common.sharding import make_mesh
    from repro_torch.kernels import attention as kattn

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
    try:
        check(dist.get_backend() == "nccl", "the mesh's group is not NCCL")
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        entry = {"card": card_line(torch), "backend": dist.get_backend(),
                 "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        t = time.perf_counter()
        entry["serve"] = mesh_serve(MESH_SERVE, mesh, dev, torch, np, kattn)
        entry["serve"]["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        entry["train"] = mesh_train(mesh, dev, torch)
        entry["train"]["seconds"] = time.perf_counter() - t
        entry["compressed_psum"] = mesh_compress(dev, torch)
    finally:
        dist.destroy_process_group()
    entry["dryrun"] = mesh_dryrun()
    check(not dist.is_initialized(), "a process group outlived phase 21")
    emit({"phase": "mesh", **entry})
    return entry


# ---------------------------------------------------------------------------
# phase 22: the kTLS-analogue bench (fig6c_ktls)
# ---------------------------------------------------------------------------

#: the kTLS-analogue bench's kernels (``csrc/ktls_attention.cu``): they
#: replace no ``pallas_call`` but the reference bench's jitted regimes
KTLS_KERNELS = ("ktls_attention", "ktls_dequant")
KTLS_REPLACES = ("benchmarks/bench_ktls_analogue.py:41-62 `plain` / "
                 "`sw_mode` / `hw_mode` (XLA fusions; no pallas_call)")
#: launches of one ``fig6c_ktls`` run: a warm-up and 5 timed calls a
#: regime a context; ``plain`` and ``sw`` attend over float K/V, ``hw``
#: over int8, and ``sw`` dequantises once a call
KTLS_BENCH_CALLS = 6


#: each regime's work, by the kernel that does it (``sw`` runs two)
KTLS_REGIMES = {"plain": "attention_float", "hw": "attention_int8",
                "sw": "sw"}


def ktls_work(ctx: int, b: int, hq: int, hkv: int, hd: int) -> dict:
    """Bytes (each input read once, each output written once) and
    operations of each kernel, and of ``sw``'s two, at one context: a key
    costs 4 hd float32 operations a query head (q k and p v, a
    multiply-add each), an int8 element 2 (a product and a division)."""
    elems = b * ctx * 2 * hkv * hd
    f32_kv, i8_kv = 4 * elems, elems + 4 * b * ctx * 2 * hkv
    q_out = 2 * 4 * b * hq * hd
    attn_ops = 4 * hd * ctx * b * hq
    return {"attention_float": (f32_kv + q_out, attn_ops),
            "attention_int8": (i8_kv + q_out, attn_ops + 2 * elems),
            "dequant": (i8_kv + f32_kv, 2 * elems),
            "sw": (i8_kv + 2 * f32_kv + q_out, attn_ops + 2 * elems)}


#: phase 22: float32 bit patterns a chunk of the dequantise pass's
#: exhaustive check (1 GiB of amax)
DIV127_CHUNK = 1 << 28


def div127_exhaustive(dev, torch, ops) -> dict:
    """``ktls_dequant`` of ``q = 1`` times every float32 bit pattern as
    ``amax``, against its plain version (the IEEE quotient by 127), in
    chunks: the kernel's quotient by 127 (``div127`` where ``amax`` lies
    in its exact range, a division elsewhere) is the correctly rounded
    quotient for every float32 (NaN against NaN)."""
    ones = torch.ones((DIV127_CHUNK, 1), dtype=torch.int8, device=dev)
    bad, first = 0, None
    for start in range(0, 1 << 32, DIV127_CHUNK):
        amax = torch.arange(start, start + DIV127_CHUNK, dtype=torch.int64,
                            device=dev).to(torch.int32).view(
                                torch.float32).view(-1, 1)
        got = ops.ktls_dequant(ones, amax, impl="cuda")
        want = ops.ktls_dequant(ones, amax, impl="ref")
        same = (got.view(torch.int32) == want.view(torch.int32)) | (
            got.isnan() & want.isnan())
        n = int((~same).sum().item())
        if n and first is None:
            i = int((~same).nonzero()[0, 0].item())
            first = {"bits": hex((start + i) & 0xFFFFFFFF),
                     "got": got[i, 0].item(), "want": want[i, 0].item()}
        bad += n
        del amax, got, want, same
    check(bad == 0, f"ktls_dequant: {bad} float32 patterns differ from the "
          f"IEEE quotient by 127 (first {first})")
    return {"patterns": 1 << 32, "mismatches": bad}


def ktls_analogue(dev, torch, np, ops, kktls) -> dict:
    """Phase 22: the kTLS-analogue bench on the card. At each context of
    ``benchmarks_torch/bench_ktls_analogue.py``, on its draws: the
    dequantise kernel against its plain version bit for bit (and the plain
    version on the card against the CPU's; first over every float32 bit
    pattern, :func:`div127_exhaustive`), the float and int8 attention
    kernels against theirs within ``ATTN_TOL``; then ``benchmarks_torch.run
    --only fig6c_ktls --device cuda`` in this process, into a temporary
    directory (no ``ERROR`` row, every row there, each kernel launched as
    the regimes call it); then CUDA-event times (clean L2) of each kernel,
    regime, plain version and of ``scaled_dot_product_attention`` (scale
    1) beside the float attention, with their bounds. Whether ``hw <
    plain < sw`` holds is recorded, not checked."""
    import contextlib
    import io
    import tempfile

    from benchmarks_torch import bench_ktls_analogue as bench
    from benchmarks_torch import run as brun

    sdpa = torch.nn.functional.scaled_dot_product_attention
    frate = peak_ops_per_s(torch, FP32_OPS_PER_SM_CLOCK)
    shape = dict(b=bench.B, hq=bench.HQ, hkv=bench.HKV, hd=bench.HD)
    exhaustive = div127_exhaustive(dev, torch, ops)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)          # the bench's draws, in order
    per_ctx, errs = {}, {"attention_float": 0.0, "attention_int8": 0.0,
                         "dequant": 0.0}
    for ctx in bench.CONTEXTS:
        q = torch.from_numpy(rng.standard_normal(
            (shape["b"], shape["hq"], shape["hd"])).astype(np.float32)
        ).to(dev)
        kv = torch.from_numpy(rng.standard_normal(
            (shape["b"], ctx, 2, shape["hkv"], shape["hd"])
        ).astype(np.float32)).to(dev)
        kq, amax = bench.quant(kv)
        deq_k = ops.ktls_dequant(kq, amax, impl="cuda")
        deq_r = ops.ktls_dequant(kq, amax, impl="ref")
        check(torch.equal(deq_k, deq_r),
              f"ktls_dequant ctx {ctx}: not bit-identical to the plain "
              f"version ({(deq_k != deq_r).sum().item()} elements differ)")
        check(torch.equal(deq_r.cpu(), ops.ktls_dequant(
                  kq.cpu(), amax.cpu(), impl="ref")),
              f"ktls_dequant_ref ctx {ctx}: the card's differs from the "
              "CPU's")
        row = {"max_abs_err": {}, "allclose": {}}
        for name, args in (("attention_float", (q, kv)),
                           ("attention_int8", (q, kq, amax))):
            got = ops.ktls_attention(*args, impl="cuda")
            want = ops.ktls_attention(*args, impl="ref")
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            row["max_abs_err"][name] = err
            row["allclose"][name] = torch.allclose(got, want, **ATTN_TOL)
            errs[name] = max(errs[name], err)
            check(row["allclose"][name],
                  f"ktls {name} ctx {ctx}: max abs error {err} against "
                  f"the plain version is past {ATTN_TOL}")
        del deq_k, deq_r
        k_t = kv[:, :, 0].transpose(1, 2)
        v_t = kv[:, :, 1].transpose(1, 2)
        lib = sdpa(q[:, :, None], k_t, v_t, scale=1.0)[:, :, 0]
        row["library_max_abs_err"] = (
            lib - ops.ktls_attention(q, kv, impl="ref")).abs().max().item()
        fns = {
            "attention_float": lambda: ops.ktls_attention(q, kv,
                                                          impl="cuda"),
            "attention_int8": lambda: ops.ktls_attention(q, kq, amax,
                                                         impl="cuda"),
            "dequant": lambda: ops.ktls_dequant(kq, amax, impl="cuda"),
            "sw": lambda: bench.sw_mode(q, kq, amax),
        }
        plain_fns = {
            "attention_float": lambda: ops.ktls_attention(q, kv,
                                                          impl="ref"),
            "attention_int8": lambda: ops.ktls_attention(q, kq, amax,
                                                         impl="ref"),
            "dequant": lambda: ops.ktls_dequant(kq, amax, impl="ref"),
        }
        work = ktls_work(ctx, **shape)
        timed = {}
        for name, (nbytes, nops) in work.items():
            bms, by, _ = bound(nbytes, nops, frate)
            timed[name] = {"ms": time_ms(fns[name], torch, clean_l2=True),
                           "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                           "ops": nops}
            if name in plain_fns:
                timed[name]["plain_ms"] = time_ms(plain_fns[name], torch,
                                                  clean_l2=True)
        timed["attention_float"]["library_ms"] = time_ms(
            lambda: sdpa(q[:, :, None], k_t, v_t, scale=1.0), torch,
            clean_l2=True)
        for name in ("attention_int8", "dequant"):
            timed[name]["library_ms"] = None   # no single call does it
        row["timing"] = timed
        per_ctx[ctx] = row
        del q, kv, kq, amax, k_t, v_t, lib
        torch.cuda.empty_cache()

    kktls.reset_launches()
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            with contextlib.redirect_stdout(out):
                brun.main(["--only", "fig6c_ktls", "--device", "cuda",
                           "--out", tmp])
        except SystemExit as exc:
            raise SmokeError(f"fig6c_ktls: {exc}") from exc
        torch.cuda.synchronize()
        rows = bench_rows(Path(tmp) / "BENCH_fig6c_ktls.json")
    launches = dict(kktls.LAUNCHES)
    by_kv = dict(kktls.KV_LAUNCHES)
    want_rows = [f"fig6c_ktls_ctx{c}_{m}" for c in bench.CONTEXTS
                 for m in ("plain", "sw", "hw")]
    for r in rows:
        check_bench_row("fig6c_ktls", r)
    check([r["name"] for r in rows] == want_rows,
          f"fig6c_ktls rows {[r['name'] for r in rows]}, expected "
          f"{want_rows}")
    n = KTLS_BENCH_CALLS * len(bench.CONTEXTS)
    check(launches == {"ktls_attention": 3 * n, "ktls_dequant": n}
          and by_kv == {"float32": 2 * n, "int8": n},
          f"fig6c_ktls launched {launches} ({by_kv}); each regime's kernel "
          f"{n} times expected")
    bench_us = {r["name"].split("_", 2)[2]: r["us_per_call"] for r in rows}
    big = per_ctx[bench.CONTEXTS[-1]]["timing"]
    order = {"bench": {k: bench_us[f"ctx{bench.CONTEXTS[-1]}_{k}"]
                       for k in ("hw", "plain", "sw")},
             "events": {k: big[KTLS_REGIMES[k]]["ms"]
                        for k in ("hw", "plain", "sw")}}
    for v in order.values():
        v["hw_lt_plain_lt_sw"] = v["hw"] < v["plain"] < v["sw"]
    emit({"phase": "ktls_analogue", "card": card_line(torch),
          "shape": shape, "dequant_every_float32": exhaustive,
          "contexts": per_ctx, "bench_us": bench_us,
          "bench_csv": out.getvalue().splitlines(),
          "launches": launches, "kv_launches": by_kv,
          "order_at_largest_ctx": order})
    return {"launches": launches, "kv_launches": by_kv, "errs": errs,
            "timing": big, "ctx": bench.CONTEXTS[-1]}


# ---------------------------------------------------------------------------
# phase 23: examples/proxy_serving_torch.py
# ---------------------------------------------------------------------------

#: phase 23 (b): the example's serving part with the full libra-proxy-125m
#: (12 layers, d_model 768); its requests, batch, pages and tokens are the
#: example's (a 4-token header and 40 payload tokens, 6 new)
PROXY_SERVE = ServeSize(arch="libra-proxy-125m", requests=8, max_batch=4,
                        prompt=44, header=4, gen=6, page=8)
#: the VPIs the example prints: drawn from a per-stack random secret
VPI_RE = r"vpi=0x[0-9a-f]+"
VPI_MASK = "vpi=0x?"


def load_example(name: str):
    """``examples/<name>.py`` as a module (it puts ``src`` on the path)."""
    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def proxy_serve_run(example, model, params, dev, torch, kattn,
                    margins=None) -> dict:
    """One ``serving_proxy`` of ``example`` on ``model``: its printed lines,
    ``EngineStats``, ``CopyCounters``, launches and tokens. ``margins``
    (a :class:`LogitMargins` of ``model``) notes where each token came
    from, through ``LibraEngine.step`` (which the example's loop and
    ``run()`` call) for the run."""
    import contextlib
    import io
    import re
    import types

    from repro_torch.serving import engine as tengine

    inner = tengine.LibraEngine.step

    def step(eng):
        view = types.SimpleNamespace(waiting=eng.waiting,
                                     step=lambda: inner(eng))
        margins.step(view, list(eng.waiting) + list(eng.active))

    kattn.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        if margins is not None:
            tengine.LibraEngine.step = step
        with contextlib.redirect_stdout(out):
            eng = example.serving_proxy(dev, params=params, model=model)
        torch.cuda.synchronize()
    finally:
        tengine.LibraEngine.step = inner
    dt = time.perf_counter() - t0
    check(len(eng.pool.registry) == 0,
          f"proxy_serving {model.attn_impl}: VPIs left registered")
    lines = out.getvalue().splitlines()
    return {"seconds": dt, "lines": lines,
            "pages": {"free": eng.pool.alloc.free_pages,
                      "total": eng.pool.alloc.total_pages},
            "masked": [re.sub(VPI_RE, VPI_MASK, ln) for ln in lines],
            "stats": dataclasses.asdict(eng.stats),
            "counters": dataclasses.asdict(eng.stack.counters),
            "launches": dict(kattn.LAUNCHES),
            "outputs": {r.rid: list(r.output) for r in eng.completed}}


def proxy_serving(dev, torch, np, kattn) -> dict:
    """Phase 23: ``examples/proxy_serving_torch.py`` on the card. (a) The
    script as a subprocess with no arguments (``cuda``): exit 0, and its
    stream part's lines equal those ``stream_proxy("cpu")`` prints (host
    numpy either way). (b) Its ``serving_proxy`` loop with the full
    libra-proxy-125m, 8 requests, through the kernels (``attn_impl=
    'auto'``) and through the plain versions (``'ref'``) on the same
    parameters: tokens equal under phase 6's near-tie rule, ``EngineStats``,
    ``CopyCounters``, the printed lines (the VPIs masked: each stack
    draws its secret at random) and the free pages equal (a forwarded
    handle's pages stay held, a fault of the reference, carried: ROADMAP
    section 3, F6), ``flash_attention`` launched once a layer a prefill
    and ``paged_attention`` once a layer a decode step in the kernel run,
    neither in the plain run."""
    import contextlib
    import io

    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "proxy_serving_torch.py")],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    script_s = time.perf_counter() - t0
    check(res.returncode == 0,
          f"proxy_serving_torch.py exited {res.returncode}:\n"
          f"{res.stderr[-2000:]}")
    example = load_example("proxy_serving_torch")
    cpu_out = io.StringIO()
    with contextlib.redirect_stdout(cpu_out):
        example.stream_proxy("cpu")
    stream_cpu = cpu_out.getvalue().splitlines()
    card_lines = res.stdout.splitlines()
    check(card_lines[:len(stream_cpu)] == stream_cpu,
          "proxy_serving_torch.py: the card run's stream lines differ from "
          f"the CPU's:\n{card_lines[:len(stream_cpu)]}\n{stream_cpu}")
    check(sum(ln.startswith("req ") for ln in card_lines) == 8 and
          "--- serving proxy summary ---" in card_lines,
          "proxy_serving_torch.py: the serving part printed "
          f"{card_lines[len(stream_cpu):]}")

    ss = PROXY_SERVE
    cfg = ss.config()
    models = {impl: build_model(cfg, page_size=ss.page, attn_impl=impl)
              for impl in ("auto", "ref")}
    params = models["auto"].init_params(ss.seed, device=dev)
    margins = LogitMargins(models["ref"])
    kern_run = proxy_serve_run(example, models["auto"], params, dev, torch,
                               kattn)
    ref_run = proxy_serve_run(example, models["ref"], params, dev, torch,
                              kattn, margins)
    check(sorted(kern_run["outputs"]) == list(range(1, ss.requests + 1)),
          f"proxy_serving: completed {sorted(kern_run['outputs'])}")
    diverged = near_tie_diverged(ss, kern_run["outputs"],
                                 ref_run["outputs"], margins,
                                 "proxy_serving kernel vs plain")
    for k in ("stats", "counters", "masked", "pages"):
        check(kern_run[k] == ref_run[k],
              f"proxy_serving: {k} differ between the kernel and plain "
              f"runs:\n{kern_run[k]}\n{ref_run[k]}")
    st = kern_run["stats"]
    want = {"flash_attention": cfg.num_layers * st["prefills"],
            "paged_attention": cfg.num_layers * st["steps"]}
    check(kern_run["launches"] == want,
          f"proxy_serving: launched {kern_run['launches']}, expected {want}")
    check(not any(ref_run["launches"].values()),
          f"proxy_serving: the plain run launched {ref_run['launches']}")
    entry = {"phase": "proxy_serving", "script_seconds": script_s,
             "script_stdout": card_lines, "arch": ss.arch,
             "params": cfg.param_count(), "layers": cfg.num_layers,
             "d_model": cfg.d_model, "requests": ss.requests,
             "identical_tokens": not diverged, "diverged": diverged,
             "stats": st, "counters": kern_run["counters"],
             "pages": kern_run["pages"], "launches": kern_run["launches"],
             "seconds": {"kernels": kern_run["seconds"],
                         "plain": ref_run["seconds"]},
             "lines": kern_run["lines"]}
    emit(entry)
    return entry


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SmokeError("src/repro_torch not found next to chip_smoke.py: "
                         "run it from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device: the smoke run needs one GPU")
    # float32 products in full float32: the plain versions are references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import ktls_attention as kktls
    from repro_torch.kernels import mlstm_scan as kmlstm
    from repro_torch.kernels import selective_copy as kern
    from repro_torch.kernels import testing as tt

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if sys.argv[1:2] == ["--linear"]:
        return linear(dev, torch, ops, _build)
    if sys.argv[1:2] == ["--mlstm-ab"]:
        with_serve = sys.argv[2:3] == ["--serve"]
        srcs = sys.argv[2 + with_serve:]
        check(srcs, "--mlstm-ab takes mlstm_scan.cu sources")
        return mlstm_ab(srcs, dev, torch, np, ops, _build, with_serve)
    if sys.argv[1:2] == ["--flash-ab"]:
        check(sys.argv[2:], "--flash-ab takes flash_attention.cu sources")
        return flash_ab(sys.argv[2:], dev, torch, ops, _build)
    if sys.argv[1:2] == ["--paged-ab"]:
        check(sys.argv[2:], "--paged-ab takes paged_attention.cu sources")
        return paged_ab(sys.argv[2:], dev, torch, ops, _build)
    if sys.argv[1:2] == ["--gather-ab"]:
        check(sys.argv[2:], "--gather-ab takes selective_gather.cu sources")
        return gather_ab(sys.argv[2:], dev, torch, np, ops, tt, _build)
    if sys.argv[1:2] == ["--fused-ab"]:
        check(sys.argv[2:], "--fused-ab takes fused_round.cu sources")
        return fused_ab(sys.argv[2:], dev, torch, np, ops, tt, _build)
    if sys.argv[1:2] == ["--copy-ab"]:
        check(sys.argv[2:], "--copy-ab takes selective_copy.cu sources")
        return copy_ab(sys.argv[2:], dev, torch, np, ops, tt, _build)
    if sys.argv[1:2] == ["--policy-ab"]:
        check(sys.argv[2:], "--policy-ab takes policy_match.cu sources")
        return policy_ab(sys.argv[2:], dev, torch, np, ops, tt, _build)
    size = Size()
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)),
          "sources": [str(p.relative_to(ROOT)) for p in _build.sources()],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    par = timed("parity", parity, size, dev, torch, np, ops, tt)
    runs = {}
    for tls in (None, "hw"):
        runs[tls or "plaintext"] = timed(f"e2e_{tls or 'plaintext'}", e2e,
                                         size, tls, dev, torch, np, core, kern)
    timed("audit", audit, size, dev, torch, np, core)
    timed("trace", trace, size, dev, torch, np, core)
    timed("cluster", cluster, size, dev, torch, np, core, kern)
    timed("depth", depth, size, dev, torch, np, core, kern)
    bench_launches = timed("benches", benches, dev, torch, kern, kattn,
                           kmlstm)
    ss = ServeSize()
    cfg = get_config(ss.arch)
    served = [(s, s.config()) for s in MOE_RUNS + DENSE_RUNS + HYBRID_RUNS
              + (VLM_RUN, ENCDEC_RUN)]
    apar = timed("attn_parity", attn_parity, ss, cfg, dev, torch, ops,
                 ATTN_KERNELS, served)
    srv_state = timed("serve", serve, ss, dev, torch, np, kattn)
    srv = srv_state["libra"]
    base = timed("baselines", baselines, ss, srv_state, dev, torch, np,
                 kattn)
    del srv_state                   # phase 15 needs 64 GB of the card
    gc.collect()
    torch.cuda.empty_cache()
    cfg_runs = {phase: timed(phase, config_runs, phase, runs, dev, torch, np,
                             kattn)
                for phase, runs in (("moe_serve", MOE_RUNS),
                                    ("dense_configs", DENSE_RUNS),
                                    ("hybrid_serve", HYBRID_RUNS))}
    direct = {phase: timed(phase, direct_serve, phase, run, dev, torch, np,
                           kattn)
              for phase, run in (("vlm_serve", VLM_RUN),
                                 ("encdec_serve", ENCDEC_RUN))}
    xs = XlstmSize()
    mpar = timed("mlstm_parity", mlstm_parity, xs, get_config(xs.arch), dev,
                 torch, ops)
    xsrv = timed("xlstm_serve", xlstm_serve, xs, dev, torch, np, kmlstm)
    tim = timed("timing", timing, size, ss, xs, dev, torch, np, ops, tt)
    gc.collect()
    torch.cuda.empty_cache()
    timed("train", train_phase, dev, torch, np)
    timed("mesh", mesh_phase, dev, torch, np)
    ktls = timed("ktls_analogue", ktls_analogue, dev, torch, np, ops, kktls)
    timed("proxy_serving", proxy_serving, dev, torch, np, kattn)
    emit({"phase_seconds": phase_s})

    print(card_line(torch), flush=True)

    kernels = []
    for name, replaces in KERNELS.items():
        first = tim[name][0]
        if name in DATAPATH:
            launches = sum(r["launches"][name] for rs in runs.values()
                           for r in rs)
            err = max(r["max_abs_err"] for r in par if r["kernel"] == name)
        elif name == "mlstm_scan":
            launches = xsrv["launches"][name]
            err = max(r["max_abs_err"] for r in mpar)
        else:
            launches = srv["launches"][name]
            err = max(r["max_abs_err"] for r in apar if r["kernel"] == name)
        check(launches > 0, f"{name} never launched on the main path")
        extra = ({"baseline_launches": {n: r["launches"][name]
                                        for n, r in base.items()}}
                 if name == "flash_attention" else {})
        if name in ATTN_KERNELS:
            extra["config_launches"] = {
                arch: r["kernels"]["launches"][name]
                for runs in cfg_runs.values() for arch, r in runs.items()}
            extra["config_launches"].update(
                {r["arch"]: r["kernels"]["launches"][name]
                 for r in direct.values()})
            row_keys = ("variant", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")
            extra["windowed"] = {k: next(
                r for r in tim[name] if "window=" in r["variant"])[k]
                for k in row_keys}
            extra["direct_shapes"] = [
                {k: r[k] for k in ("shape_of",) + row_keys}
                for r in tim[name] if "shape_of" in r]
        extra["bench_launches"] = bench_launches[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "variant": first["variant"],
            **extra,
        })
        if "fp32_fma_bound_ms" in first:
            kernels[-1]["fp32_fma_bound_ms"] = first["fp32_fma_bound_ms"]
    row_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, timing_key, extra in (
            ("ktls_attention", "attention_float",
             {"kv_launches": ktls["kv_launches"],
              "int8": {k: ktls["timing"]["attention_int8"][k]
                       for k in row_keys}}),
            ("ktls_dequant", "dequant", {})):
        t = ktls["timing"][timing_key]
        launches = ktls["launches"][name]
        check(launches > 0, f"{name} never launched on the main path")
        err = (max(ktls["errs"]["attention_float"],
                   ktls["errs"]["attention_int8"])
               if name == "ktls_attention" else ktls["errs"]["dequant"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ktls_attention.cu",
            "replaces": KTLS_REPLACES, "launches": launches,
            "max_abs_err": err, **{k: t[k] for k in row_keys},
            "variant": f"fig6c_ktls ctx {ktls['ctx']}, B=8, 12 heads of 64"
                       + (", float32 K/V" if name == "ktls_attention"
                          else ""),
            **extra,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # every failure is fatal: no result line
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
