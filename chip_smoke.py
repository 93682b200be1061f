#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels
against their plain versions.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one report line each (every check raises on failure):

1. versions, and the card's name and power limit from ``nvidia-smi``;
2. build of every kernel source under ``src/repro_torch/csrc``
   (``maxplus_fold.cu``, ``flash_attention.cu``, ``flash_attention_ext.cu``,
   ``rglru_scan.cu``) for ``sm_90a``, one ``nvcc`` each, all started
   together, each one's seconds logged;
3. the (max,+) fold kernel against ``maxplus_fold_ref`` on the card,
   required equal by ``torch.equal``, in five variants (periodic,
   periodic+energy, indexed, indexed+arrivals+extras,
   indexed+energy+arrivals+extras), each through both routes (the compact
   route on a ``maxplus_form`` dictionary, the dense route on a random
   dictionary the compact route's precondition refuses), at a small shape
   here and at the real size after phase 5 (the dense route there on the
   two indexed variants of the same dictionary with -0.0 in s0's origin
   row, which the precondition refuses); the compact route's pre-pass against its CPU twin
   (``kernels/maxplus/compact.py``), its records bit-equal;
4. paper Tables 3/4/5 through the port's entry points on the card: each
   cell through ``steady_bandwidth_mb_s`` (``scan`` engine) and through
   ``Simulator.run(..., engine="cuda")``, agreeing within 1e-6 relative;
   the Table 3 cells also through the periodic kernel branch
   (``bandwidth_maxplus_mb_s``); the paper pins of the JAX package's
   ``tests/test_sim_paper_tables.py``; Table 5 with scan / cuda / oracle
   energy agreement under 1e-3;
5. the real-size design-space sweep: one 65536-op mixed trace on 8
   channels x 16 ways (N = 146, M = 512 combos) under 64 design-point
   tables through ``sweep_tables(..., engine="cuda")``, checked bit-equal
   to the plain version on the card and within 1e-5 of the numpy oracle
   on two points, with the kernel's and the plain version's times; and
   the trace-indexed launches of phase 4 (one per Table 3/4/5 cell)
   counted by geometry, one launch of each geometry timed (both routes,
   the pre-pass alone), their sum, bound and launches x (time - bound)
   reported apart from the sweep's; every launch of phases 4 and 5 must
   take the compact route;

3b. the many-trace kernel against ``maxplus_fold_many_ref``, required
   equal by ``torch.equal``, in four variants (arrivals on/off x faults
   on/off), each through both routes, at a small shape with mixed lane
   lengths;
6. the fleet at full width: 256 mixed traces on 8 channels x 16 ways
   (N = 146) of 4096-32768 ops, even lanes with Poisson arrivals at 80 %
   of the drive's own rate, every fourth lane with read-retry-like
   surcharges, plus 32 traces on 4 x 8, through
   ``Simulator.run_many(engine="cuda")`` (one many-trace launch per
   geometry): the kernel bit-equal to its plain version on the whole
   fleet, bit-equal to per-trace ``run(engine="cuda")`` on 8 lanes, the
   ``scan`` engine's ``run_many`` within T * 2^-24 on the traces of at
   most 8192 ops (``FLEET_SCAN_OPS``), 2 lanes exact against
   the numpy oracle on 0.25 us-dyadic timing; both launches must take the
   compact route; the dense route bit-equal to the plain version on the
   whole fleet too; kernel (both routes, the pre-pass alone), plain and
   bound times and the wall time of both engines' ``run_many``;
7. sweeps, streaming and calibration: ``Simulator.sweep`` equal to phase
   5's ``sweep_tables``; ``sweep_steady_bandwidth_mb_s`` equal to the
   per-point channel bandwidth on the 15 Table 3 SLC write cells;
   ``fit_slc`` equal to the JAX package's fit; the stripe exponents; a
   65536-op ``mixed_trace_chunks`` stream on 4 x 8 MLC bit-equal to the
   scan engine on the materialised trace, and a 131072-op stream timed,
   with host and device memory peaks against the shorter stream's;
8. LM serving on RecurrentGemma-9B: (8a) the flash-attention kernels
   against ``attention_reference`` on 13 small shapes (the JAX package's
   FLASH_CASES, ragged S, D = 256, MQA, S > window) within FLASH_TOL, each
   shape through both routes (bf16 inputs to the tensor-core kernel, f32
   copies to the CUDA-core kernel, and the other way round), the
   RG-LRU scan kernel (K5) bit-equal to ``rglru_scan_ref`` through both
   routes: the ring on 46 shapes at its edges (S = 1, Tc - 1, Tc, Tc + 1
   and 5 stages plus a ragged tail; each channel tile C; R not a multiple
   of C; B > 1; f32 and bf16) and the simple route on 4 inputs TMA
   cannot read, each route's launches
   counted; and the SMOKE model served on
   the card token-identical to the CPU plain path; (8b) the full-width
   model (8.6 B parameters, bf16) initialised on the card from a seed and
   served through ``ServingEngine.generate`` — 4 prompts of 2560-4096
   tokens left-padded to 4096 plus 32 greedy tokens — with one launch of
   K4's tensor-core kernel per attention layer (12, none of the CUDA-core
   one) and one K5 launch per RG-LRU layer (26, all on the ring route) in
   the prefill, prefill seconds, decode tokens/s and peak device memory,
   the first K4 and K5 launches of the prefill recorded and held against
   their plain versions, and one ``score`` at B = 1, S = 1024 (26 K5
   launches, all on the ring, the first held bit-equal); (8c) K4 and K5
   timed at the prefill shapes beside their plain versions, their bounds
   and (K4) ``scaled_dot_product_attention`` with the window mask, the
   flops K4 computes (from its tile plan) and its TFLOP/s, K4's CUDA-core
   route timed on f32 copies of the same inputs, and the ptxas registers
   and shared memory of both routes; K5 at the prefill and the score
   shapes through the ring and the simple route, each as one call (the
   measure of every kernel's ``ms``) and as one of K5_QUEUED queued
   launches, with the share of its bytes bound, the ring's ptxas
   registers and shared memory, and ``torch.add`` on the same tensors as
   a yardstick of the bytes; where a shape's tensors fit in the L2 (the
   score shape), the timed calls rotate over copies that do not;
9. request-level workloads on 8 channels x 16 ways (SLC, PROPOSED, N =
   146), offered at 80 % of the drive's own rate for the mix (the stream
   with zero arrivals on ``engine="cuda"``, ops over ``end_us``): (9a) a
   16384-request, 4-page Poisson stream (70 % reads) with a
   ``FaultSpec`` of read retries, jitter, program faults and 10 % hedged
   reads through ``Simulator.run(..., objective="all")`` on ``cuda``:
   the query's first K1 launch recorded and held bit-equal to
   ``maxplus_fold_ref`` (its end time the query's), every K1 launch on
   the compact route, ``n_remap_ops > 0``, ``retry_hist`` summing to the
   read ops; on the stream's first 4096 requests (``WL_SCAN_REQUESTS``,
   cut for time) ``scan`` against ``cuda``: end times within T * 2^-24,
   energies within 1e-3, the same remaps and retries, scan's
   p50/p99/p99.9 within 1e-3 of the ``oracle``'s; and a 4096-request
   prefix's latencies on the card bit-equal to the CPU's;
   (9b) an 8192-request, 2-page stream under the retry-storm spec plus
   program and erase faults through both dynamic policies on ``scan``,
   the card's placements, parities, completions and latencies bit-equal
   to the CPU's and no op on a retired way.  Each query's wall and ops/s,
   the host's lowering, hedging and fault sampling apart, K1's one call
   beside its bound, the percentiles, ``retry_hist`` and ``n_remap_ops``;
10. the log-depth engines, plain torch on the card (no kernel of ours;
   none may launch): (10a) phase 5's sweep through ``sweep_tables`` on
   its default engine, ``prefix`` (chain combine, segment_len 64), within
   T * 2^-24 of phase 5's ``cuda`` ends and bit-equal to the CPU on 2
   points, ``combine="assoc"`` on 2 points bit-equal to the CPU; its wall
   (median of 3) beside phase 5's, the staging of its inputs apart, the
   device time of its kernels by ``torch.profiler``, its peak memory;
   (10b) ``sweep_steady_bandwidth_mb_s(engine="squaring")`` on the 30
   Table 3/4 write points (ways 1-16) bit-equal to the CPU and within
   T * 2^-24 of ``scan``, and ``Simulator.run(steady_trace,
   engine="squaring", objective="all")`` on the 60 Table 3 cells within
   T * 2^-24 of ``scan`` and against the paper pins; (10c) phase 9a's
   workload query on ``prefix`` within T * 2^-24 of the ``cuda`` query's
   end time and energy (the drift of cuda's one-add-an-op float32 energy
   sum), and within 1e-3 of the float64 per-op energy sum of the same
   trace, its wall; (10d) ``ops.maxplus_fold`` with
   ``strategy="segmented"`` and ``"squaring"`` on phase 3's small
   dictionaries within T * 2^-24 of K1's plain version.  Every fold of
   10a-10c is checked to have run on the card.
11. the FTL (slice E) on 8 channels x 16 ways (SLC, PROPOSED): (11a) the
   JAX package's default ``FTLSpec`` with 512 blocks of 64 pages (OP
   0.25, greedy, preconditioned: 78642 silent writes) under a
   saturating 4096-request overwrite stream (30 % reads) over 90 % of
   the logical space: the card's ``translate_scan`` op-for-op equal to
   the numpy ``ftl.translate`` (classes, payloads, request ids, GC flags,
   arrivals, ``FTLStats`` and the final drive state), its steps, steps/s,
   launches a step (``torch.profiler`` on eager steps) and idle share;
   ``Simulator.run(stream, ftl=spec, objective="all")`` on ``cuda``,
   ``scan`` and ``oracle``: cuda vs scan within T * 2^-24, each engine
   within 1e-3 of the oracle, scan's p50/p99/p99.9 within 1e-3 of the
   oracle's, ``gc_op_count > 0`` and ``mb_s < fresh_mb_s``, the query's
   first K1 launch held bit-equal to ``maxplus_fold_ref`` (its route
   reported, not forced), WAF beside ``analytic_waf``, and a
   4096-request prefix (the whole stream) priced on the card bit-equal to
   the CPU; (11b) that prefix with program and erase failures (the host translator's
   path) on ``cuda``: ``blocks_retired > 0``, ``retry_hist`` summing to
   the read-class ops, bit-equal to a CPU session; (11c) ``run_stream``
   over 1024-request chunks equal to 11a's one-shot ``scan`` query (end,
   WAF, ``ftl_stats``, ops, bytes), and with per-op faults on the
   4096-request prefix in chunks of 2048 equal to the one-shot query with
   that spec;
   (11d) an 8-point aged sweep (``ftl_bench._scan_vs_host``'s OP range)
   within 1e-3 of per-point ``run`` (prefix) on its first and last points,
   bit-equal to the CPU on one, a warm second sweep equal to the first;
   (11e) greedy's WAF
   on ``ftl_bench._waf_sweep``'s full-size spec within 10 % of
   ``analytic_waf``.  Every translation, scan and sweep fold of the
   phase is checked to have run on the card.
12. the storage tier (``repro_torch.storage``): (12a) phase 8b's model,
   cut to ``CKPT_LAYERS`` of its 38 layers (10 GB), initialised on the
   card from the same seed, checkpointed by
   ``CheckpointEngine(channels=4, ways=4)`` into a temporary directory
   (the room it needs checked first: an error, not a skip, when it is
   short), ``wait()`` returning this step's ``SaveResult``, its modeled
   stall equal to a CPU session's, then ``restore(template=)`` and
   ``place_on_device``: every leaf bit-equal on the card; then two
   non-blocking saves of the model's first 1 GiB of leaves while the
   card runs a loop of small bf16 matmuls, the first pricing its stall
   on the writer thread, the second reusing it: the loop's ms a step
   beside its ms alone; (12b) a
   2^28-token ``StripedTokenStore`` over 8 shards read by
   ``FileBackedTokens(batch=32, seq=4096, ways=4)``, 128 batches moved
   to the card (tokens/s from the page cache: the store was just
   written), a resume from ``PipeState`` giving the same batch, the
   batches equal to numpy reads of the shards, ``pipeline_io_trace``
   priced on the card equal to the CPU; (12c) ``plan_kv_offload`` at
   524288 tokens for ``recurrentgemma-9b`` (inapplicable: its attention
   is windowed) and for the same config with every window removed,
   equal to the CPU; (12d) the planning flows of
   ``examples/ssd_design_space.py`` (its KV-offload loop over qwen2-0.5b,
   recurrentgemma-9b and xlstm-350m, checkpoint-stall plans (the three
   budgets share their estimates of a geometry), the 10 GiB
   dataloader refill planned by trace, by bytes and by energy,
   ``compare_interfaces``), one plan and every comparison row equal to
   a CPU session's, with the scan engine's ops/s and one estimate's
   device busy share; (12e) the checkpoint, pipeline and KV traces
   priced on ``engine="cuda"``: K1 on the compact route every launch,
   end time and op energies within T * 2^-24 of ``scan``, the first
   launch bit-equal to ``maxplus_fold_ref``;
13. the rest of slice H's serving path: (13a) the SMOKE models of the
   nine other configs at float32 compute, the same parameters on the
   card and the CPU, through ``ServingEngine.generate`` (3 prompts, 12
   greedy tokens, identical) or, for musicgen-medium, ``prefill`` and
   ``decode_step`` on embeddings, and for qwen2-vl-2b also on non-text
   M-RoPE ids, logits within 1e-4 of the largest; one launch of K4's
   CUDA-core route per attention layer of a prefill (granite-3-2b at
   D = 8, zero-padded to 16), none of K5; the MoE routing tables under
   the margin rule (tokens whose k-th and (k+1)-th router logits differ
   by more than 1e-5 of the largest: the same experts and slots, weights
   within 2^-18; near ties under 1 %); (13b) qwen2-0.5b and (13c)
   granite-moe-3b-a800m at full width and depth, initialised on the
   card from a seed and served as phase 8b's wave (24 and 32 launches of
   K4's tensor-core route, none of the CUDA-core one), the first K4
   launch held within FLASH_TOL and timed as in 8c; 13c's dropped
   (token, expert) pairs a prefill layer, and its first MoE layer on its
   recorded input against the same layer on the CPU (routing under the
   margin rule, outputs within 2^-5 of the largest); (13d) qwen2-vl-2b
   at full width and depth, ``prefill`` at B = 2, S = 4096 on Qwen2-VL's
   image layout of M-RoPE ids (64 text tokens, a 32 x 32 patch grid,
   text resuming after the largest id), 28 tensor-core K4 launches at
   D = 128, then 16 ``decode_step``s; (13e) xlstm-350m at full width and
   depth served as the same wave with no K4 or K5 launch, its sLSTM
   scans timed apart, and ``prefill`` of 4097 tokens against ``prefill``
   of 4096 plus one ``decode_step`` (chunkwise against step) within 2^-5
   of the largest logit.  Each full model is freed before the next.
14. training on the card (``phase_train``): (14a) K4's forward with the
   rows' log-sum-exp (its output unchanged) and its backward kernels
   against ``attention_lse_reference`` / ``attention_backward_reference``
   on phase 8a's self-attention cases and the slice's shapes (D 8 -> 16,
   64, 128, 256; no window, windows 300 and 2048; groups 1-16; S 100,
   1000, 2100; both dtypes) within FLASH_BWD_TOL and LSE_TOL, two calls
   bit-equal, each through its dtype's route (bf16 the tensor-core
   kernels, f32 the CUDA-core ones, asserted by the per-route counts),
   and the gradient of ``ops.flash_attention`` on the grouped layout at
   B = 2 against the CPU's plain one; K5's reverse mode bit-equal to
   ``rglru_scan_backward_ref`` on both routes, one launch a call; (14b)
   qwen2-0.5b ``CONFIG`` at full width and depth, train state from seed 0, one
   step's loss and every gradient leaf with the kernels against the same
   step with their plain versions on the card (TRAIN_*_TOL), then one
   ``make_train_step`` step (2 x 4096 tokens, ``grad_accum=2``, remat
   full) with its K4 forward and backward launches; (14c)
   ``Trainer.run()`` from that state: 8 steps, WSD, a checkpoint every 4,
   a failure injected at step 6, one restart, the replayed steps against
   their first pass, step times alone and during a save, tokens/s, model
   flops over 989 TFLOP/s, peak memory, snapshot / write / restore
   seconds; (14d) recurrentgemma-9b at full width, depth cut to 5 layers
   (2.05 B parameters), int8 moments: loss and gradients against the
   plain versions, two steps with K5's ring and K4's D = 256 windowed
   launches counted; K4's backward timed at 14b's and 14d's shapes beside
   its plain version, its operations bound and SDPA's backward, and K5's
   reverse mode at 14d's shape beside its bytes bound; one more step of
   14b and of 14d profiled by kernel name (``step_split``: the port's
   kernels' device time a step among the rest); every K4 backward of
   14b, 14c and 14d must take the tensor-core route.
15. the dry run against the card (``phase_dryrun``): (15a) for the calls
   phases 8b and 13b (the wave's prefill) and 14b and 14d (one train
   step) measured with ``CallMemory`` — the bytes of their argument
   tensors and their rise of allocated memory, this script's clones
   taken out — ``launch.steps.plan_cell`` and ``launch.dryrun.run_meta``
   on the ``card`` mesh: the planned argument bytes equal, the predicted
   peak within DRYRUN_PEAK_TOL of the rise; (15b) all ten ids'
   ``train_4k`` through ``dryrun.run_cell`` on the 16 x 16 and
   2 x 16 x 16 meshes, every sharded dim dividing, llama4's per-device
   train state printed; (15c) ``make_dp_grad_sync`` on a one-rank NCCL
   group (a ``FileStore`` in a temporary directory) over 14b's gradients,
   compressed and not, bit-equal to the int8 quantise / dequantise done
   leaf by leaf in plain torch.
16. caller positions and the logit soft cap (``phase_positions``): (16a)
   K4's EXT instantiations, which work in position order (the plan's
   stable sort, its band pre-pass ``flash_pos_band`` and, on the tensor
   cores, the sorted copies of ``flash_pos_gather``; then the forward
   with and without lse and the backward) on both routes against their
   plain versions at the slice's shape, q [1, 14, 4096, 64] with two kv
   heads on packed documents (lengths drawn uniform in 256-2048 from
   LM_SEED, positions restarting at each) and a cap of 50.0, q scaled by
   8 so that the scores reach about +-36 and the cap's tanh is far from
   linear; the backward's bar is shown to fail the same backward without
   the cap's factor 1 - t^2 (the plain version with it dropped); the two
   pre-passes against their twins (``tiles.pos_band``, ``index_select``);
   timed beside their bound (the operations of the kept pairs), the index
   path on the same inputs, the cap alone on ``arange`` positions (the
   identity plan: the index band with the cap) and SDPA with the
   positions' boolean mask (no PyTorch call computes the cap); the tiles
   each schedule visits (the sorted band, PR 25's positional rule, the
   index path); (16b) qwen2-0.5b at full width and depth with
   ``attn_softcap=50.0`` (Gemma 2's published logit cap) on a 2 x 4096
   packed batch (``batch["positions"]``, remat full, two microbatches):
   the step's loss, gradient norm and leaves against the same step with
   the plain attention, then one train step and one scoring ``forward``
   (no gradient, against the plain attention's), every K4 launch of both
   on the tensor-core route's EXT instantiation, one plan and one band
   pre-pass a forward.
17. the multi-device paths (``phase_multi``): (17a) over a points mesh
   of two shards of ``cuda:0`` (and one over every card where the host
   has two or more): phase 5's 64-point sweep through ``sweep_tables``
   on ``prefix``, phase 10b's 30 write points through
   ``sweep_steady_bandwidth_mb_s`` on ``scan`` and ``squaring``,
   ``run_many(engine="scan")`` on 5 traces of 1000-2000 ops on 8 x 16,
   and an aged ``sweep(ftl=)`` of 2 points at phase 11a's spec over its
   stream's first 1024 requests, each bit-equal to the same call with
   ``shard=False`` and every block counted on its device, both walls
   printed; (17b) qwen2-0.5b ``CONFIG`` at full width and depth on a
   one-rank NCCL group: 3 ``Trainer`` steps on phase 14's batches
   mesh-less and on a ``(1, 1)`` data mesh with ZeRO-1, the histories,
   the kernel launches and every leaf of the final state bit-equal, the
   step's seconds and peak beside 14c's; (17c) two gloo ranks sharing
   ``cuda:0`` (spawned processes) run the data-parallel ``Trainer`` on
   qwen2-0.5b SMOKE (f32, ragged masks, two microbatches, ZeRO-1) and
   recurrentgemma-9b SMOKE (int8 moments), held against the mesh-less
   ``Trainer`` on the card at the bars of
   ``tests/test_torch_train_step.py``.  Phase 17 adds no kernel; the
   data-parallel steps launch K4 and K5 forwards and backwards.
18. tensor parallelism over ``model`` (``phase_tp``), on gloo ranks
   sharing ``cuda:0`` (NCCL refuses two ranks on one card; spawned
   processes, each set once): (18a) qwen2-0.5b ``CONFIG`` at full width,
   ``TP_QWEN_LAYERS`` deep, on a ``(1, 2)`` mesh (kv heads, FFN and the
   tied vocabulary split) on 14b's batches, and (18b) 14d's recurrentgemma-9b cut (query
   groups at D = 256, the RG-LRU's 2048 channels a rank, int8 moments):
   the first batch's loss, global norm and every gradient leaf against
   the mesh-less ones at 14b's bars, ``TP_STEPS`` ``Trainer`` steps
   against the mesh-less ``Trainer``'s in the same call, each rank's
   step seconds, peak, K4 / K5 launches and all-reduces; (18c) qwen2-0.5b
   cut to ``TP_SEQ_LAYERS`` layers on ``(1, 4)``: neither heads nor
   groups divide, so each rank's S / 4 queries attend at their
   ``q_offset`` to every key through K4's forward and its backward over
   a query chunk, the step against the mesh-less one; that chunk
   backward alone against its plain version on each of the four chunks
   (unseen keys' dk / dv exactly 0), timed beside its bound and SDPA
   with the chunk's mask; (18d) the same four ranks as ``(2, 2)`` on
   qwen2-0.5b SMOKE (ZeRO-1, int8 moments, two microbatches) and
   granite-moe-3b-a800m SMOKE (experts split) against the mesh-less
   ``Trainer``, 17c's bars.  Times of ranks sharing one card measure
   correctness, not a speed-up.
19. serving under ``model`` (``phase_serve_tp``): four gloo ranks
   sharing ``cuda:0`` (one spawn) run ``launch.steps.make_serve_prefill``
   / ``make_serve_decode`` on their slices of the parameters and the
   cache against the mesh-less ``prefill`` + ``decode_step`` at the same
   depth in the same call, on two left-padded prompts of 4096 and 2560
   tokens and 32 decode steps fed the mesh-less greedy tokens: (19a)
   qwen2-0.5b at 18a's 12 layers on ``(1, 2)`` (kv heads) on ranks 0-1
   while (19c) recurrentgemma-9b at 14d's 5 layers runs on ``(1, 2)``
   (query groups over one kv head, the RG-LRU's channels; the window's
   ring wraps, 1024 slots a rank) on ranks 2-3, then (19b) qwen2-0.5b at
   18c's 4 layers on ``(1, 4)`` (the sequence-sharded prefill: K4 on each
   rank's queries at its ``q_offset``): every call's logits within the
   bf16 bar of the largest, greedy tokens equal (or the mesh-less top-2
   gap under the bar), the final norm's outputs bit-equal across the
   ranks, K4 / K5 launches and collectives a rank, the prefill's seconds
   and decode tokens/s; (19d) the dry run's plan of one rank's program
   (``plan_cell(rank=)`` on meta) against the pairs: 19a's prefill and
   first decode step on ranks 0-1 and 18a's train step on ranks 2-3 log
   exactly the collectives the rank issued (kind, calls, bytes), the
   predicted peak within ``DRYRUN_PEAK_TOL`` of the call's measured rise.
20. parameters split over ``data`` (``phase_fsdp``): four gloo ranks
   sharing ``cuda:0`` (one spawn): (20a) qwen2-0.5b at 18a's 12 layers
   with ``fsdp_units`` (ZeRO-3: each rank a block of every unit leaf and
   the final norm, a unit gathered where it runs, again in the remat's
   backward, its gradients reduce-scattered) takes one
   ``mesh_train_step`` step of 14b's batch on ``(2, 1)`` (ranks 0-1) and
   on ``(2, 2)``, its loss, norm and every gradient leaf (each rank's
   blocks against the mesh-less gradient's) within phase 18's bars, a
   rank's parameter bytes under 18a's; (20b) llama4 at its published
   widths cut to one dense + MoE unit and 8 experts, ``fsdp_units`` on
   ``(2, 1)`` (ranks 2-3, beside 20a's pair): phase 19's wave and 8
   decode steps fed the mesh-less greedy tokens, logits within the bf16
   bar, the bytes gathered a decode step; (20c) granite-moe-3b-a800m at 4
   layers on ``(2, 2)`` under ``moe_shard_mode`` ``f_model`` (each
   expert's d_ff over ``model``) and ``e_data_f_model`` (the experts
   over ``data``, the slots exchanged to their owners by all-to-all), one
   step each within 20a's bars; (20d) the dry run's plans of 20a's and
   20c's ``e_data_f_model`` (2, 2) steps on every position, their
   collectives equal to the rank's, their peaks within
   ``DRYRUN_PEAK_TOL`` of the step's measured rise.

Phases 4 and 5 are the main path of the per-design-point kernel (with the
workload query of 9a, whose K1 launches its report adds, and the FTL
query of 11a and the storage pricing of 12e, each reported as its own
entry), phase 6 that
of the many-trace kernel, ``generate`` in phase 8 that of K4 and K5 (and
the prefills of 13b-13d, each reported as its own K4 entry),
``Trainer.run()`` in 14c that of K4's backward and 14d's two steps that
of K5's, 16b's train step and scoring forward that of K4's EXT
instantiations, 18c's step on rank 0 that of K4's chunk backward, each
rank's serving in 19a-19c (K4's and K5's ``phase19_launches``) and each
rank's step or serving in 20a-20c (K4's ``phase20_launches``): the
launch counts are reset just before each and read just after.  The
bounds of the (max,+) kernels count what their inputs need (each input
read once, the dense dictionary by the pre-pass; per step the add/max
pairs of the kept entries and the side operations of the rows the op
writes, read off the pre-pass's records); the dense count, 2*N^2 max/add
operations a step, is printed beside them.  The
line before the last is the JSON kernel report, the last line the JSON
device summary.  Exits non-zero without a result when no CUDA device is
present.  Each phase's wall is logged to both streams as it ends
(``[clock]``), and a run still going after ``WATCHDOG_S`` prints every
thread's stack to standard error and exits 1.
"""

from __future__ import annotations

import contextlib
import datetime
import faulthandler
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and float32
# (non-tensor-core) rate; the bound is the larger of bytes/rate and
# operations/rate.
HBM_BYTES_PER_S = 3.35e12
# the script's own limit is 1200 s: past WATCHDOG_S it dumps the stacks of
# its threads to standard error and exits, so a stall shows where it is
WATCHDOG_S = 1140
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core rate

# The scan engine adds each op's offsets one float32 add at a time; the
# (max,+) dictionary pre-sums them in float64 and rounds each entry once.
# Both are exact float32 evaluations of the same recurrence that round
# differently, so on a T-op trace they may drift apart by about T float32
# half-ulps of the end time: the bar is T * 2**-24 relative (the JAX
# package's own scan and pallas engines differ the same way).
F32_DRIFT_PER_OP = 2.0 ** -24
REL_TOL_ORACLE = 1e-5       # kernel vs oracle where float32 sums are exact
DYADIC_US = 0.25            # timing quantum that makes every sum exact
ENERGY_TOL = 1e-3           # Table 5 scan / cuda / oracle agreement
# paper pins of tests/test_sim_paper_tables.py (JAX package)
ANOMALIES = {("slc", "read", 2, "proposed")}
T3_MEAN_TOL, T3_WORST_TOL, T4_MEAN_TOL = 0.04, 0.16, 0.05

SWEEP_OPS, SWEEP_CHANNELS, SWEEP_WAYS, SWEEP_POINTS = 65536, 8, 16, 64
# phase 6: the fleet (lengths 2**u, u uniform on FLEET_LOG2_OPS)
# (FLEET_LANES was 512 until phase 20 came: the fleet's build 16.9 s, its
# plain fold 19.7 s)
FLEET_LANES, FLEET_CHANNELS, FLEET_WAYS = 256, 8, 16
FLEET_SMALL_LANES, FLEET_SMALL_CHANNELS, FLEET_SMALL_WAYS = 32, 4, 8
# (traces of up to 65536 ops until phase 20 came: the fleet's plain fold
# 17.8 s at 256 lanes)
FLEET_LOG2_OPS = (12.0, 15.0)
# the scan engine steps every op from the host (some 0.9 ms a step): it is
# held to cuda on the fleet's traces of at most FLEET_SCAN_OPS ops (the
# whole fleet's longest trace took it 56.6 s)
FLEET_SCAN_OPS = 8192
OFFERED_LOAD = 0.8          # arrival rate / the drive's rate on the trace
FAULT_SHARE, FAULT_US = 0.02, (30.0, 120.0)
# phase 7: streams on scale_bench's 4 x 8 MLC geometry
STREAM_CHANNELS, STREAM_WAYS = 4, 8
# (STREAM_CHECK_OPS was 65536 and STREAM_OPS 131072 until phase 20 came,
# 20.4 s of phase 7 at 32768 / 65536; STREAM_OPS was 262144 until the
# script neared its time limit, 32.0 s)
STREAM_CHECK_OPS, STREAM_CHECK_CHUNK = 16384, 4096
STREAM_OPS, STREAM_CHUNK = 32768, 8192
# what the JAX package's calibrate.fit_slc() returns (t_prog us, t_poll
# cycles, write MAE); its frozen nand.SLC holds t_prog = 218 us
REFERENCE_FIT_SLC = (217.0, 0.0, 0.026098169557506812)
# phase 8: RecurrentGemma-9B served at full width: four prompts longer than
# the 2048-token attention window, left-padded into one 4096-token wave (so
# the ring of _ring_align wraps), 32 greedy tokens; scoring at B = 1
LM_ARCH, LM_SEED = "recurrentgemma-9b", 0
LM_PROMPT_LENS = (4096, 3584, 3072, 2560)
LM_NEW_TOKENS, LM_MAX_SEQ = 32, 4128
LM_SCORE = (1, 1024)
# phase 14: training on the card.  qwen2-0.5b at full width and depth on
# TRAIN_4K's sequence, its global batch of 256 cut to TRAIN_BATCH (one
# card), in TRAIN_ACCUM microbatches; the Trainer's run: TRAIN_STEPS
# steps, WSD (warmup 1, stable 5, decay 2), a checkpoint every
# TRAIN_CKPT_EVERY, a failure injected at step TRAIN_FAIL_AT
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 2, 4096, 2
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8, 4, 6
TRAIN_WSD = (3e-4, 1, 5, 2)
# recurrentgemma-9b at full width, its 38 layers cut to one unit and the
# (R, R) tail: the train state of 8.58 B parameters does not fit one card
RG_LAYERS, RG_BATCH, RG_STEPS = 5, 1, 2
# K4's backward against its plain version, relative to each output's
# largest magnitude: float32 sums in another order; in bf16 each output
# is rounded to bf16 (half an ulp is 2^-9 of an element); the forward's
# lse relative to its largest magnitude
FLASH_BWD_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 1e-2}
LSE_TOL = 1e-5
# a step's loss and gradients with the kernels against the same step with
# their plain versions on the card, at bf16 compute: the kernel and the
# plain attention round their bf16 outputs and gradients at other places,
# and the backward carries those roundings through every layer.  The loss
# relative, the global gradient norm relative, each leaf's relative L2
# distance
TRAIN_LOSS_TOL, TRAIN_NORM_TOL, TRAIN_LEAF_TOL = 1e-3, 2e-2, 0.1
LEAF_FLOOR = 1e-3
# a replayed step against its first pass where they are not bit-equal
REPLAY_TOL = 1e-3
# phase 15a: the dry run's predicted peak (the meta run's storages, charged
# as the caching allocator charges a block) against the rise a call of
# phases 8b, 13b, 14b and 14d measured, relative to the measured rise;
# 19d holds its rank plans to it too.  A plan counts the step's own
# storages, not cuBLAS's workspace (32 MiB a stream, taken from the
# caching allocator at the stream's first product and kept): 19d's ranks
# make it before any measured call, as phase 15's calls come after
# earlier products
DRYRUN_PEAK_TOL = 0.15
# the flash-attention kernel against its plain version, relative to
# max(1, max |plain|): float32 sums in another order; bfloat16 outputs
# rounded to bf16 (an ulp is 2^-7 of the magnitude) after such sums
FLASH_TOL = {"torch.float32": 5e-5, "torch.bfloat16": 2.5e-2}
# K5's ``ms`` is one call between CUDA events, as for every kernel; beside
# it, the device time of one of K5_QUEUED launches queued behind a kernel
# that sleeps SLEEP_CYCLES (some 10 ms), which leaves out the wrapper's host
# time.  Where a, b and h fit L2_ROTATE times over in the H100's 50 MB L2,
# the timed calls rotate over copies of them, so each call reads its inputs
# from device memory
K5_QUEUED, SLEEP_CYCLES = 10, 20_000_000
L2_BYTES, L2_ROTATE = 50 * 2 ** 20, 4
# phase 9: request-level workloads on the paper's widest geometry, offered
# at OFFERED_LOAD of the drive's own rate for the mix.  9a: static stripe
# with faults and hedges; 9b: dynamic dispatch under the reliability
# bench's retry-storm spec plus program and erase faults (retired ways)
WL_CHANNELS, WL_WAYS, WL_READ_FRACTION = 8, 16, 0.7
# (WL_REQUESTS was 65536 until phase 20 came: its K1 launch's plain fold
# took 17.9 s)
WL_REQUESTS, WL_PAGES, WL_SEED, WL_PREFIX = 16384, 4, 0, 4096
# 9a's scan query (and the cuda and oracle runs it is held to) folds the
# stream's first WL_SCAN_REQUESTS requests: the whole stream's scan took
# 98.6 s of the script's 1200 s, its first 32768 requests 47.4 s, and
# the script passed its 1100 s margin once phase 17 came; 8192 took 12.4 s
# until phase 19 came
WL_SCAN_REQUESTS = 4096
WL_STATIC_FAULTS = dict(wear=0.95, jitter_us=2.0, prog_fail_prob=0.02,
                        hedge_fraction=0.1, seed=17)
# (9b's stream had 16384 requests, 23.7 s on the card and the CPU, until
# the script neared its time limit; 8192 still retire 3 ways)
WL_DYN_REQUESTS, WL_DYN_PAGES, WL_DYN_SEED = 8192, 2, 1
WL_DYN_FAULTS = dict(wear=1.0, rber_worn=3e-5, max_retries=4,
                     retry_step_us=(500.0, 1000.0, 2000.0, 4000.0),
                     prog_fail_prob=0.02, erase_fail_prob=0.05, seed=7)
PERCENTILE_TOL = 1e-3       # scan vs oracle request-latency percentiles
# phase 10: the prefix sweep held bit-equal to the CPU on these points,
# combine="assoc" run on these
# (assoc ran on 4 points, 16.9 s on the CPU, until the script neared its
# time limit)
PREFIX_CPU_POINTS, PREFIX_ASSOC_POINTS = (0, 37), (0, 63)
# phase 11: the FTL on 8 x 16 SLC.  11a: the JAX package's default spec
# with blocks raised to FTL_BLOCKS (32768 pages: 1024 blocks took phase 11
# past its 150 s, the time going to sequential translation steps and the
# CPU's eager preconditioning), under a saturating
# overwrite stream over 90 % of the logical space (ftl_bench's
# _bandwidth_cliff); 11b its first FTL_PREFIX requests with block
# failures; 11c in chunks of FTL_CHUNK requests (with per-op faults on
# the first FTL_FAULT_CHUNKED requests, chunks of FTL_FAULT_CHUNK); 11d
# ftl_bench._scan_vs_host's points (FTL_SWEEP_OPS); 11e
# ftl_bench._waf_sweep's full-size greedy point
FTL_BLOCKS, FTL_PPB, FTL_OP = 512, 64, 0.25
# (FTL_REQUESTS was 32768, then 16384, until the script neared its time
# limit: at 16384 11a's scan query took 18.1 s and 11c's chunked one
# 14.6 s; then 8192 until phase 20 came, the chunks 4096)
FTL_REQUESTS, FTL_READ_FRACTION, FTL_SEED = 4096, 0.3, 5
FTL_PREFIX, FTL_CHUNK, FTL_FAULT_CHUNKED, FTL_FAULT_CHUNK = \
    4096, 1024, 4096, 2048
# program failures at 1e-4, not 1e-3: at 1e-3 the preconditioning's
# ~2e5 programs (~4e5 at 1024 blocks) fail some 200 times, each marking
# its block bad, and the retirements outrun the 102-block spare pool —
# the drive dies before the stream starts (ftl.translate raises, in the
# JAX package too)
FTL_BLOCK_FAULTS = dict(wear=0.6, jitter_us=0.4, prog_fail_prob=1e-4,
                        erase_fail_prob=1e-3, seed=13)
FTL_OP_FAULTS = dict(wear=0.6, jitter_us=0.4, seed=13)
FTL_AGREEMENT = 1e-3        # ftl_bench's engine agreement gate
# (16 points of 6000 requests until phase 20 came: cold 10.5 s, warm 8.6 s)
FTL_SWEEP_OPS = (0.12, 0.5, 8)      # np.linspace arguments
FTL_SWEEP_REQUESTS, FTL_SWEEP_SEED = 4000, 7
# (4 run points and 2 CPU points, 16.3 s together, until the script
# neared its time limit)
FTL_SWEEP_RUN_POINTS, FTL_SWEEP_CPU_POINTS = (0, 7), (4,)
FTL_WAF_BLOCKS, FTL_WAF_REQUESTS, FTL_WAF_SEED, WAF_PIN_TOL = \
    256, 60000, 11, 0.10
# phase 12: the storage tier.  12a checkpoints phase 8b's model
# (RecurrentGemma-9B at CKPT_LAYERS layers, 10 GB bf16) through
# CheckpointEngine; 12b feeds
# the card from a 1 GiB striped token store (a real corpus is terabytes;
# the pipeline's shapes are the training stack's); 12c plans KV offload
# at the 500k-token decode shape; 12d runs examples/ssd_design_space.py's
# planning flows
CKPT_CHANNELS, CKPT_WAYS, CKPT_STEP = 4, 4, 1
# 12a's model: RecurrentGemma-9B cut to CKPT_LAYERS of its 38 layers
# (whole until phase 20 came: 17.16 GB, its save 10.9 s and restore 17.8 s)
CKPT_LAYERS = 20
PIPE_TOKENS, PIPE_SHARDS, PIPE_SEED = 1 << 28, 8, 3
PIPE_BATCH, PIPE_SEQ, PIPE_WAYS, PIPE_BATCHES = 32, 4096, 4, 128
PIPE_RESUME_AT, PIPE_CHECK_EVERY = 64, 16
KV_SEQ = 524288
KV_ARCHS = ("qwen2-0.5b", "recurrentgemma-9b", "xlstm-350m")
KV_FIELDS = ("applicable", "state_bytes_per_seq", "hot_bytes_per_seq",
             "cold_bytes_per_seq", "read_mb_per_token", "tokens_per_s",
             "note")
OVERLAP_BYTES, OVERLAP_DIM, OVERLAP_STEPS = 1 << 30, 2048, 200
PLAN_CKPT_BYTES = int(2.7e9 * 2 * 3)    # 2.7B params, bf16 + optimizer
# 150 s: an MLC geometry; 95 s: the SLC tier after every MLC geometry
# misses; 30 s: no geometry meets it (plan_checkpoint_tier's None)
PLAN_BUDGETS, PLAN_CPU_BUDGET = (150.0, 95.0, 30.0), 150.0
REFILL_BYTES = 10 << 30
# phase 13: the rest of slice H.  13a the SMOKE models of the nine other
# configs; 13b-13e four full configs on phase 8b's wave (13d on
# Qwen2-VL's image layout instead, 13e adds a chunkwise-vs-step check).
# MoE routing: the margin rule of ROUTE_TIE_REL, weights within
# ROUTE_WEIGHT_TOL (float32 router sums in another order)
H_SMOKES = ("qwen2-0.5b", "minicpm-2b", "granite-3-2b", "starcoder2-3b",
            "llama4-maverick-400b-a17b", "granite-moe-3b-a800m",
            "musicgen-medium", "qwen2-vl-2b", "xlstm-350m")
ROUTE_TIE_REL, ROUTE_WEIGHT_TOL = 1e-5, 2.0 ** -18
VL_BATCH, VL_SEQ, VL_TEXT, VL_GRID, VL_DECODE = 2, 4096, 64, 32, 16
# chunkwise prefill vs step decode at bf16: 2^-5 of the largest logit,
# the bf16 bar of tests/test_torch_models.py
XL_BATCH, XL_SEQ, XL_TOL = 2, 4096, 2.0 ** -5
ENERGY_FIELDS = ("cmd_j", "io_j", "ecc_j", "ctrl_j", "idle_j", "array_j")
TIMING_COLUMNS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
                  "ctrl_us", "arb_us", "io_us")


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseClock:
    """Wall seconds of each phase, logged as it ends to standard output
    and to standard error, so that the end of either shows how far a run
    got and where its time went."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.walls: dict[str, float] = {}

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.walls[label] = now - self.last
        self.last = now
        msg = (f"[clock] phase {label} took {self.walls[label]:.1f} s; "
               f"{now - self.start:.1f} s since the start")
        log(msg)
        print(msg, file=sys.stderr, flush=True)


def cuda_ms(fn, reps: int = 3, warmup: bool = True) -> float:
    """Median CUDA-event time (ms) of ``fn`` over ``reps`` runs."""
    import torch
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, n: int = K5_QUEUED, reps: int = 3) -> float:
    """Median over ``reps`` of the device time (ms) of one of ``n`` calls
    of ``fn`` queued behind a sleeping kernel: the card starts the first
    call only after the host has issued them all."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def record_ops(rec, sides: int):
    """Operations one step of each combo needs, read off the compact
    pre-pass's records [C, 32]: an add and a max per kept entry of each
    written row (a short row's padding repeats an entry, so entries are
    counted once), and 2 per written row for each of ``sides`` side
    operations (arrival max-in: add, max; fault shift: mul, add)."""
    import torch
    c = rec.shape[0]
    cols = rec[:, 24:28].contiguous().view(torch.uint8).reshape(c, 4, 4)
    count = rec[:, 29].long()
    eq = cols[..., :, None] == cols[..., None, :]
    kept = (~torch.tril(eq, -1).any(-1)).sum(-1)              # [C, rows]
    written = torch.arange(4, device=rec.device) < count[:, None]
    return (2 * kept * written).sum(-1) + 2 * sides * count


def fold_work(mats, t_steps, inputs, outputs, idx=None, gvec=None,
              wvec=None, p=0) -> tuple[float, float, float]:
    """(bytes, operations, the dense count's operations) of one K1/K2 fold,
    counted for what these inputs need: every input read once (the dense
    dictionary by the pre-pass), every output written once; per step the
    ``record_ops`` of its combo and ``p`` energy adds.  The dense count
    is 2*N^2 max/add a step per design point."""
    import torch
    from repro_torch.kernels.maxplus import kernel as K
    b, m, n, _ = mats.shape
    n_bytes = sum(x.numel() * x.element_size()
                  for x in (mats, gvec, wvec, *inputs, *outputs)
                  if x is not None)
    rec, _ = K.maxplus_compact_kernel(mats, gvec, wvec)
    per = record_ops(rec, 2 if gvec is not None else 0).reshape(b, m) + p
    steps = (idx[:t_steps].long() if idx is not None else
             torch.arange(t_steps, device=mats.device) % m)
    counts = torch.bincount(steps, minlength=m)
    ops = float((per.double() * counts.double()).sum())
    return float(n_bytes), ops, 2.0 * t_steps * b * n * n


def refused_s0(s0):
    """``s0`` with -0.0 in its origin row (the last): the compact route's
    precondition refuses a set sign bit, so these otherwise equal inputs
    take the dense route."""
    s0 = s0.clone()
    s0[..., -1] = -0.0
    return s0


def route_delta(before: dict, branch: str) -> dict:
    """Fold launches of ``branch`` by route since ``before``."""
    from repro_torch.kernels.maxplus import kernel as K
    return {r: K.LAUNCHES[f"{branch}/{r}"] - before[f"{branch}/{r}"]
            for r in K.ROUTES}


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------


def variant_inputs(mats, t_steps, seed, device, gvec=None, wvec=None):
    """Seeded side inputs for the five variants: indices, arrivals,
    extras, energies, and arrival templates / written-rows masks where
    the caller has none of its own."""
    import numpy as np
    import torch
    from repro_torch.core.maxplus_form import NEG

    b, m, n, _ = mats.shape
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    idx = torch.as_tensor(rng.integers(0, m, t_steps).astype(np.int32),
                          device=device)
    arrivals = f32(np.cumsum(rng.exponential(8.0, t_steps)))
    extras = f32(np.where(rng.random(t_steps) < 0.1,
                          rng.uniform(5.0, 50.0, t_steps), 0.0))
    energy = f32(rng.uniform(0.0, 2.0, (b, m, 5)))
    if gvec is None:
        gvec = f32(np.where(rng.random((b, m, n)) < 0.2,
                            rng.uniform(0.0, 30.0, (b, m, n)), NEG))
    if wvec is None:
        wvec = f32((rng.random((b, m, n)) < 0.1).astype(np.float32))
    return idx, arrivals, extras, energy, gvec, wvec


def check_variants(label, mats, s0, t_steps, inputs, route,
                   names=None) -> float:
    """Five kernel-vs-plain variants (those of ``names`` alone if given),
    each required to take ``route``; returns the max abs difference (0.0:
    every check is torch.equal)."""
    import torch
    from repro_torch.kernels.maxplus import kernel as K
    from repro_torch.kernels.maxplus.kernel import maxplus_fold_kernel
    from repro_torch.kernels.maxplus.ref import maxplus_fold_ref

    idx, arrivals, extras, energy, gvec, wvec = inputs
    side = dict(arrivals=arrivals, gvec=gvec, extras=extras, wvec=wvec)
    variants = {
        "periodic": dict(),
        "periodic+energy": dict(energy=energy),
        "indexed": dict(idx=idx),
        "indexed+arrivals+extras": dict(idx=idx, **side),
        "indexed+energy+arrivals+extras": dict(idx=idx, energy=energy,
                                               **side),
    }
    worst = 0.0
    for name, kw in variants.items():
        if names is not None and name not in names:
            continue
        before = dict(K.LAUNCHES)
        got = maxplus_fold_kernel(mats, s0, t_steps=t_steps, **kw)
        taken = route_delta(before, "indexed" if "idx" in kw else "periodic")
        want = maxplus_fold_ref(mats, s0, t_steps=t_steps, **kw)
        torch.cuda.synchronize()
        if taken != {r: int(r == route) for r in K.ROUTES}:
            raise AssertionError(f"{label} {name}: took {taken}, expected "
                                 f"the {route} route")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                diff = float((g - w).abs().max())
                raise AssertionError(f"{label} {name}: kernel != plain "
                                     f"(max abs diff {diff})")
            worst = max(worst, float((g - w).abs().max()))
    log(f"[3] kernel == plain ({label}, B={mats.shape[0]} M={mats.shape[1]} "
        f"N={mats.shape[2]} T={t_steps}): "
        f"{len(names) if names is not None else 5} variants torch.equal, all "
        f"through the {route} route")
    return worst


def small_dictionary(device, channels=4, ways=8, b=3, t=301, seed=11):
    """(mats [B, M, N, N], gvec, wvec, idx) of a mixed trace's combo
    dictionary under ``b`` seeded tables, on ``device``."""
    import numpy as np
    import torch
    from repro_torch.core import maxplus_form as mf
    from repro_torch.core.trace import mixed_trace, op_class_table
    from repro_torch.core.sim import SSDConfig

    rng = np.random.default_rng(seed)
    tr = mixed_trace(t, channels, ways, 0.6, seed=seed)
    layout = mf.StateLayout(channels, ways)
    combos, idx = mf.trace_combos(tr)
    base = op_class_table(SSDConfig(channels=channels, ways=ways))
    tabs = [timing_columns(base, lambda q, c, f=rng.uniform(0.8, 1.2, 8):
                           c * f[q]) for _ in range(b)]
    mats = np.stack([mf.combo_matrices(x, combos, layout) for x in tabs])
    gvec = np.stack([mf.combo_arrival_offsets(x, combos, layout)
                     for x in tabs])
    w = mf.combo_written_rows(combos, layout)
    wvec = np.ascontiguousarray(np.broadcast_to(w, (b,) + w.shape))
    return tuple(torch.as_tensor(x, device=device)
                 for x in (mats, gvec, wvec, idx))


def check_prepass(label, mats, gvec, wvec, **values) -> None:
    """The card's pre-pass against its twin (``compact.py``, plain torch
    run on the same device): records bit-equal, both flags clear."""
    import torch
    from repro_torch.kernels.maxplus import compact
    from repro_torch.kernels.maxplus import kernel as K

    rec, flag = K.maxplus_compact_kernel(mats, gvec, wvec, **values)
    twin, ok = compact.compact(mats, gvec, wvec)     # plain torch, same device
    if not (ok and int(flag) == 0 and torch.equal(rec, compact.pack(twin))):
        raise AssertionError(f"{label}: pre-pass != its CPU twin (flag "
                             f"{int(flag)}, twin accepts {ok})")
    log(f"[3] pre-pass == CPU twin ({label}, {rec.shape[0]} combos of "
        f"N={mats.shape[-1]}): records bit-equal, precondition met, at most "
        f"{int(twin.count.max())} rows a combo")


def small_cases(device) -> list:
    """Phase 3's two small dictionaries as (label, mats, s0, t, inputs):
    a random one (B=3 M=7 N=37) and a 4 x 8 ``maxplus_form`` one, each
    with its seeded variant inputs."""
    import numpy as np
    import torch
    from repro_torch.core.maxplus_form import NEG

    rng = np.random.default_rng(11)
    b, m, n, t = 3, 7, 37, 301
    mats = np.where(rng.random((b, m, n, n)) < 0.3,
                    rng.uniform(0.0, 40.0, (b, m, n, n)), NEG)
    mats[:, :, np.arange(n), np.arange(n)] = 0.0
    mats = torch.as_tensor(mats.astype(np.float32), device=device)
    s0 = torch.as_tensor(rng.uniform(0.0, 5.0, (b, n)).astype(np.float32),
                         device=device)
    cases = [("small, random dictionary", mats, s0, t,
              variant_inputs(mats, t, 12, device))]
    mats, gvec, wvec, idx = small_dictionary(device, b=b, t=t)
    s0 = torch.as_tensor(rng.uniform(0.0, 5.0, (b, mats.shape[-1])).astype(
        np.float32), device=device)
    inputs = variant_inputs(mats, t, 12, device, gvec=gvec, wvec=wvec)
    return cases + [("small, 4x8 dictionary", mats, s0, t,
                     (idx,) + inputs[1:])]


def phase_small_variants(device) -> None:
    (rlabel, rmats, rs0, t, rin), (label, mats, s0, _, inputs) = \
        small_cases(device)
    check_variants(rlabel, rmats, rs0, t, rin, "dense")
    check_variants(label, mats, s0, t, inputs, "compact")
    check_prepass(label, mats, inputs[4], inputs[5], s0=s0,
                  arrivals=inputs[1], extras=inputs[2])


# ---------------------------------------------------------------------------
# phase 4: Tables 3/4/5 through the port
# ---------------------------------------------------------------------------


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def phase_tables() -> dict:
    import numpy as np
    from repro_torch.api import Simulator, steady_bandwidth_mb_s
    from repro_torch.core.interface import make_interface
    from repro_torch.core.nand import chip as nand_chip
    from repro_torch.core.paper_tables import (INTERFACE_ORDER, TABLE3,
                                               TABLE4)
    from repro_torch.core.sim import page_op_params
    from repro_torch.core.trace import READ, WRITE, steady_trace
    from repro_torch.kernels.maxplus.ops import bandwidth_maxplus_mb_s
    from repro_torch.tables import cell_config, run_table5

    def both_engines(cell, mode, ways, kind, channels=1):
        cfg = cell_config(cell, ways, kind, channels)
        scan = steady_bandwidth_mb_s(cfg, mode)
        trace = steady_trace(512, channels, ways,
                             READ if mode == "read" else WRITE)
        res = Simulator.for_config(cfg).run(trace, engine="cuda")
        cuda = min(res.mb_s, cfg.sata_mb_s)
        share = rel(cuda, scan) / (trace.n_ops * F32_DRIFT_PER_OP)
        if share > 1.0:
            raise AssertionError(f"{cfg.describe()} {mode}: cuda {cuda} vs "
                                 f"scan {scan}")
        return scan, share

    t0 = time.perf_counter()
    worst_engines = 0.0
    t3_errs, t3_cells = [], []
    for cell, by_mode in TABLE3.items():
        for mode, by_ways in by_mode.items():
            for ways, row in by_ways.items():
                for kind, paper in zip(INTERFACE_ORDER, row):
                    bw, d = both_engines(cell, mode, ways, kind)
                    worst_engines = max(worst_engines, d)
                    t3_cells.append((cell, mode, ways, kind, bw))
                    if (cell, mode, ways, kind) not in ANOMALIES:
                        t3_errs.append(rel(bw, paper))
    mean3, worst3 = float(np.mean(t3_errs)), float(max(t3_errs))
    if not (mean3 < T3_MEAN_TOL and worst3 < T3_WORST_TOL):
        raise AssertionError(f"Table 3 pins: mean {mean3:.4f} (< "
                             f"{T3_MEAN_TOL}), worst {worst3:.4f} (< "
                             f"{T3_WORST_TOL})")
    # the periodic kernel branch on the same cells (single channel, so no
    # arbitration charge; every Table 3 bandwidth is below the SATA cap)
    ops = [page_op_params(make_interface(kind), nand_chip(cell), mode, ways)
           for cell, mode, ways, kind, _ in t3_cells]
    periodic = bandwidth_maxplus_mb_s(ops, [c[2] for c in t3_cells],
                                      n_pages=512)
    worst_periodic = max(rel(float(p), c[4])
                         for p, c in zip(periodic, t3_cells)) / (
                             512 * F32_DRIFT_PER_OP)
    if worst_periodic > 1.0:
        raise AssertionError(f"periodic kernel vs scan on Table 3: "
                             f"{worst_periodic:.2f} of the T*2^-24 bar")
    log(f"[4] Table 3: {len(t3_cells)} cells; scan vs cuda engine at most "
        f"{worst_engines:.2f} of the T*2^-24 bar, periodic kernel branch vs "
        f"scan at most {worst_periodic:.2f}; paper mean rel err "
        f"{mean3:.4f} (< "
        f"{T3_MEAN_TOL}), worst {worst3:.4f} (< {T3_WORST_TOL})")

    t4_errs, n4 = [], 0
    for cell, by_mode in TABLE4.items():
        for mode, by_cw in by_mode.items():
            for (channels, ways), row in by_cw.items():
                for kind, paper in zip(INTERFACE_ORDER, row):
                    bw, d = both_engines(cell, mode, ways, kind, channels)
                    worst_engines = max(worst_engines, d)
                    n4 += 1
                    if paper is None:          # the SATA2 300 MB/s cap
                        if bw < 299.0:
                            raise AssertionError(
                                f"t4 {cell}/{mode}/{channels}x{ways}/{kind}"
                                f" should hit the SATA cap, got {bw}")
                    elif (cell, mode, ways, kind) not in ANOMALIES:
                        t4_errs.append(rel(bw, paper))
    mean4 = float(np.mean(t4_errs))
    if not mean4 < T4_MEAN_TOL:
        raise AssertionError(f"Table 4 mean rel err {mean4:.4f}")
    log(f"[4] Table 4: {n4} cells; scan vs cuda at most "
        f"{worst_engines:.2f} of the T*2^-24 bar; paper mean rel err {mean4:.4f} (< "
        f"{T4_MEAN_TOL})")

    rows = run_table5()        # asserts scan/cuda/oracle energy < 1e-3
    agree = rows[-1]["value"]
    t5 = [r["rel_err"] for r in rows[:-1]]
    log(f"[4] Table 5: {len(t5)} cells, scan/cuda/oracle energy max rel "
        f"diff {agree:.2e} (< {ENERGY_TOL}); paper mean |rel err| "
        f"{float(np.mean(np.abs(t5))):.4f}; tables took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"table3_mean": mean3, "table3_worst": worst3,
            "table4_mean": mean4, "energy_agreement": agree}


# ---------------------------------------------------------------------------
# phase 5: the real-size design-space sweep
# ---------------------------------------------------------------------------


def sweep_tables_inputs():
    """The 65536-op mixed trace and 64 design-point tables: the six
    cell x interface tables of the 8 x 16 geometry, timing columns scaled
    by seeded factors in [0.8, 1.2]."""
    import numpy as np
    from repro_torch.core.interface import ALL_INTERFACES
    from repro_torch.core.nand import CellType
    from repro_torch.core.sim import SSDConfig
    from repro_torch.core.trace import mixed_trace, op_class_table

    trace = mixed_trace(SWEEP_OPS, channels=SWEEP_CHANNELS, ways=SWEEP_WAYS,
                        read_fraction=0.7, seed=0)
    bases = [op_class_table(SSDConfig(interface=k, cell=c,
                                      channels=SWEEP_CHANNELS,
                                      ways=SWEEP_WAYS))
             for c in CellType for k in ALL_INTERFACES]
    rng = np.random.default_rng(2024)
    factors = rng.uniform(0.8, 1.2, (SWEEP_POINTS, len(TIMING_COLUMNS)))
    tables = [timing_columns(bases[j % len(bases)],
                             lambda q, c, f=factors[j]: c * f[q])
              for j in range(SWEEP_POINTS)]
    return trace, tables


def timing_columns(table, fn, dtype=None):
    """``table`` with its q-th timing column c replaced by ``fn(q, c)``
    (c in float64; stored as float32 unless ``dtype`` says otherwise)."""
    import dataclasses

    import numpy as np
    return dataclasses.replace(table, **{
        name: np.asarray(fn(q, np.asarray(getattr(table, name), np.float64)),
                         dtype or np.float32)
        for q, name in enumerate(TIMING_COLUMNS)})


# ---------------------------------------------------------------------------
# phase 3b: the many-trace kernel against its plain version
# ---------------------------------------------------------------------------


def many_variants(label, args, route, lengths_note="") -> float:
    """Four kernel-vs-plain variants of the many-trace fold on ``args``
    (the keyword arguments of ``maxplus_fold_many_kernel``, with extras
    and wvec present), each required to take ``route``; returns the max
    abs difference (0.0: every check is torch.equal)."""
    import torch
    from repro_torch.kernels.maxplus import kernel as K
    from repro_torch.kernels.maxplus.kernel import maxplus_fold_many_kernel
    from repro_torch.kernels.maxplus.ref import maxplus_fold_many_ref

    worst = 0.0
    for with_arrivals in (False, True):
        for with_faults in (False, True):
            kw = dict(args, with_arrivals=with_arrivals)
            if not with_faults:
                kw.update(extras=None, wvec=None)
            before = dict(K.LAUNCHES)
            got = maxplus_fold_many_kernel(**kw)
            taken = route_delta(before, "many")
            want = maxplus_fold_many_ref(**kw)
            torch.cuda.synchronize()
            if taken != {r: int(r == route) for r in K.ROUTES}:
                raise AssertionError(
                    f"{label} arrivals={with_arrivals} faults={with_faults}:"
                    f" took {taken}, expected the {route} route")
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{label} arrivals={with_arrivals} faults="
                    f"{with_faults}: kernel != plain (max abs diff "
                    f"{float((got - want).abs().max())})")
            worst = max(worst, float((got - want).abs().max()))
    b, t = args["idx"].shape
    log(f"[3b] many-trace kernel == plain ({label}, B={b} "
        f"M1={args['mats'].shape[0]} N={args['mats'].shape[1]} T={t}"
        f"{lengths_note}): 4 variants torch.equal, all through the {route} "
        "route")
    return worst


def phase_small_many(device) -> None:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.maxplus_form import NEG

    rng = np.random.default_rng(21)
    m, n = 9, 37
    lengths = np.array([301, 1, 257, 33, 0, 300, 64], np.int32)
    b, t = len(lengths), int(lengths.max())
    mats = np.where(rng.random((m + 1, n, n)) < 0.3,
                    rng.uniform(0.0, 40.0, (m + 1, n, n)), NEG)
    mats[:, np.arange(n), np.arange(n)] = 0.0
    mats[m] = NEG
    mats[m, np.arange(n), np.arange(n)] = 0.0        # the identity pad op
    gvec = np.where(rng.random((m + 1, n)) < 0.2,
                    rng.uniform(0.0, 30.0, (m + 1, n)), NEG)
    gvec[m] = NEG
    wvec = (rng.random((m + 1, n)) < 0.1).astype(np.float32)
    wvec[m] = 0.0
    idx = np.full((b, t), m, np.int32)
    for lane, ln in enumerate(lengths):
        idx[lane, :ln] = rng.integers(0, m, ln)
    arr = np.cumsum(rng.exponential(8.0, (b, t)), axis=1)
    ext = np.where(rng.random((b, t)) < 0.1, rng.uniform(5.0, 50.0, (b, t)),
                   0.0)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    args = dict(mats=f32(mats), gvec=f32(gvec), wvec=f32(wvec),
                idx=torch.as_tensor(idx, device=device), arrivals=f32(arr),
                extras=f32(ext), s0=f32(rng.uniform(0.0, 5.0, n)),
                lengths=torch.as_tensor(lengths, device=device))
    note = f", lengths {lengths.tolist()}"
    many_variants("small, random dictionary", args, "dense", note)
    # the union dictionary of a 4 x 8 trace with the identity pad appended
    from repro_torch.core import maxplus_form as mf
    from repro_torch.core.sim import SSDConfig
    from repro_torch.core.trace import mixed_trace, op_class_table
    from repro_torch.kernels.maxplus.ops import _many_setup
    table = op_class_table(SSDConfig(channels=4, ways=8))
    traces = [mixed_trace(int(ln), 4, 8, 0.6, seed=30 + i)
              for i, ln in enumerate(lengths)]
    for i, tr in enumerate(traces):
        if i % 2 == 0:
            traces[i] = dataclasses.replace(
                tr, arrival_us=np.cumsum(rng.exponential(8.0, tr.n_ops)
                                         ).astype(np.float32))
        if i % 3 == 0:
            traces[i] = dataclasses.replace(
                traces[i], extra_us=np.where(
                    rng.random(tr.n_ops) < 0.1,
                    rng.uniform(30.0, 120.0, tr.n_ops), 0.0
                ).astype(np.float32))
    _, order, args = _many_setup(table, traces, "eager", device)
    if args["extras"] is None or not args["with_arrivals"]:
        raise AssertionError("the small fleet needs arrivals and surcharges")
    args.pop("with_arrivals")
    many_variants("small, 4x8 union dictionary", args, "compact",
                  f", lengths {sorted(lengths.tolist(), reverse=True)}")
    check_prepass("small, 4x8 union dictionary", args["mats"],
                  args["gvec"], args["wvec"], s0=args["s0"],
                  arrivals=args["arrivals"], extras=args["extras"],
                  lengths=args["lengths"])


# ---------------------------------------------------------------------------
# phase 6: the fleet at full width
# ---------------------------------------------------------------------------


def fleet_traces(table, device):
    """The 512 + 32 fleet traces: lengths round(2**u), u uniform, mixed
    read/write traffic seeded per lane; even lanes get Poisson arrivals
    whose mean gap is 1/OFFERED_LOAD times the lane's own back-to-back
    time per op (so arrivals bind on part of each trace), lanes
    i % 4 == 1 read-retry-like surcharges on FAULT_SHARE of their ops."""
    import dataclasses

    import numpy as np
    from repro_torch.core.trace import mixed_trace
    from repro_torch.kernels.maxplus.ops import run_many_end_time_maxplus

    groups = []
    for g, (lanes, channels, ways) in enumerate((
            (FLEET_LANES, FLEET_CHANNELS, FLEET_WAYS),
            (FLEET_SMALL_LANES, FLEET_SMALL_CHANNELS, FLEET_SMALL_WAYS))):
        u = np.random.default_rng(g).uniform(*FLEET_LOG2_OPS, lanes)
        n_ops = np.round(2.0 ** u).astype(int)
        seed0 = g * FLEET_LANES
        base = [mixed_trace(int(n), channels, ways, 0.7, seed=seed0 + i)
                for i, n in enumerate(n_ops)]
        # the lanes' own back-to-back end times set their arrival rates
        alone = run_many_end_time_maxplus(table, base, device=device)
        out = []
        for i, (tr, end) in enumerate(zip(base, alone)):
            rng = np.random.default_rng(10_000 + seed0 + i)
            arr = ext = None
            if i % 2 == 0:
                gap = end / tr.n_ops / OFFERED_LOAD
                arr = np.cumsum(rng.exponential(gap, tr.n_ops)
                                ).astype(np.float32)
            if i % 4 == 1:
                ext = np.where(rng.random(tr.n_ops) < FAULT_SHARE,
                               rng.uniform(*FAULT_US, tr.n_ops),
                               0.0).astype(np.float32)
            out.append(dataclasses.replace(tr, arrival_us=arr, extra_us=ext))
        groups.append(out)
    return groups


def many_work(args, out) -> tuple[float, float, float]:
    """(bytes, operations, the dense count's operations) of one many-trace
    launch, counted for what this run's data needs: the dictionary and its
    side rows (read once, by the pre-pass), the index / arrival /
    surcharge entries of the steps each lane folds, lengths, s0 and the
    states; per step the ``record_ops`` of its combo.  The dense count is
    2*N^2 max/add a step plus 2*N for each side operation."""
    import torch
    from repro_torch.kernels.maxplus import kernel as K
    m1, n, _ = args["mats"].shape
    lengths = args["lengths"]
    steps = float(lengths.sum())
    per_step = 4.0                                   # idx
    old_step = 2.0 * n * n
    n_bytes = 4.0 * m1 * n * n + 4.0 * n + 4.0 * lengths.numel()
    sides = 0
    if args["with_arrivals"]:
        per_step += 4.0
        old_step += 2.0 * n
        n_bytes += 4.0 * m1 * n
        sides += 1
    if args["extras"] is not None:
        per_step += 4.0
        old_step += 2.0 * n
        n_bytes += 4.0 * m1 * n
        sides += 1
    n_bytes += per_step * steps + out.numel() * out.element_size()
    rec, _ = K.maxplus_compact_kernel(
        args["mats"], args["gvec"] if args["with_arrivals"] else None,
        args["wvec"])
    idx = args["idx"]
    folded = (torch.arange(idx.shape[1], device=idx.device)[None, :]
              < lengths[:, None])
    counts = torch.bincount(idx[folded].long(), minlength=m1)
    ops = float((record_ops(rec, sides).double() * counts.double()).sum())
    return n_bytes, ops, old_step * steps


def time_many(args, out) -> dict:
    """One many-trace launch on ``args`` timed through both routes (the
    dense one on ``refused_s0``), the pre-pass alone, ns a step of the
    longest lane after the pre-pass, and its bounds (``many_work``)."""
    from repro_torch.kernels.maxplus import kernel as K
    ms = cuda_ms(lambda: K.maxplus_fold_many_kernel(**args))
    dense = dict(args, s0=refused_s0(args["s0"]))
    dense_ms = cuda_ms(lambda: K.maxplus_fold_many_kernel(**dense))
    arr = args["with_arrivals"]
    def prepass():
        return K.maxplus_compact_kernel(
            args["mats"], args["gvec"] if arr else None, args["wvec"],
            s0=args["s0"], arrivals=args["arrivals"] if arr else None,
            extras=args["extras"], lengths=args["lengths"])
    pre_ms = cuda_ms(prepass)
    fold_ms = compact_many_ms(prepass()[0], args)
    longest = int(args["lengths"].max())
    by, ops_, old_ops = many_work(args, out)
    b_ms, b_by = bound_ms(by, ops_)
    return {"ms": ms, "dense_ms": dense_ms, "prepass_ms": pre_ms,
            "fold_ms": fold_ms, "longest_lane": longest,
            "ns_per_step": fold_ms * 1e6 / longest,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_dense_count": bound_ms(by, old_ops)[0],
            "bytes": by, "operations": ops_, "operations_dense_count": old_ops,
            "lane_warps": K._library().maxplus_fold_many_lane_warps(
                args["idx"].shape[0])}


def phase_fleet(device) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.api import Simulator
    from repro_torch.core.interface import InterfaceKind
    from repro_torch.core.nand import CellType
    from repro_torch.core.sim import SSDConfig
    from repro_torch.core.sim_ref import simulate_trace_ref
    from repro_torch.kernels.maxplus import kernel as K
    from repro_torch.kernels.maxplus.ops import _many_setup
    from repro_torch.kernels.maxplus.ref import maxplus_fold_many_ref

    cfg = SSDConfig(cell=CellType.SLC, interface=InterfaceKind.PROPOSED,
                    channels=FLEET_CHANNELS, ways=FLEET_WAYS)
    sim = Simulator(cfg)
    t0 = time.perf_counter()
    groups = fleet_traces(sim.table, device)
    fleet = [t for g in groups for t in g]
    total_ops = sum(t.n_ops for t in fleet)
    log(f"[6] fleet: {len(groups[0])} traces on {FLEET_CHANNELS}x"
        f"{FLEET_WAYS} + {len(groups[1])} on {FLEET_SMALL_CHANNELS}x"
        f"{FLEET_SMALL_WAYS}, {total_ops} ops "
        f"({min(t.n_ops for t in fleet)}-{max(t.n_ops for t in fleet)} a "
        f"trace), built in {time.perf_counter() - t0:.1f} s")

    # -- the main path: one run_many, counts reset just before ----------
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    cuda_res = sim.run_many(fleet, engine="cuda")
    torch.cuda.synchronize()
    cuda_wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if launches["many"] != len(groups):
        raise AssertionError(f"run_many(engine='cuda') made "
                             f"{launches['many']} many-trace launches for "
                             f"{len(groups)} geometry groups")
    if launches["many/compact"] != len(groups):
        raise AssertionError(f"run_many(engine='cuda') took the dense route "
                             f"{launches['many/dense']} times")
    ends = np.array([r.end_us for r in cuda_res])
    if not (np.all(np.isfinite(ends)) and np.all(ends > 0)
            and len(ends) == len(fleet)):
        raise AssertionError("fleet end times malformed")
    log(f"[6] run_many(engine='cuda'): {len(fleet)} traces in "
        f"{cuda_wall:.2f} s wall (union dictionaries built on the host); "
        f"launches {launches}")

    # -- the kernel against its plain version on the whole fleet --------
    setups = [_many_setup(sim.table, g, "eager", device)[2] for g in groups]
    dense_setups = [dict(a, s0=refused_s0(a["s0"])) for a in setups]
    before = dict(K.LAUNCHES)
    kern = [K.maxplus_fold_many_kernel(**a) for a in setups]
    kern_dense = [K.maxplus_fold_many_kernel(**a) for a in dense_setups]
    if route_delta(before, "many") != {"compact": len(groups),
                                       "dense": len(groups)}:
        raise AssertionError(f"fleet routes: {route_delta(before, 'many')}")
    k_ms = cuda_ms(lambda: [K.maxplus_fold_many_kernel(**a)
                            for a in setups])
    plain = []
    p_ms = cuda_ms(lambda: plain.append(
        [maxplus_fold_many_ref(**a) for a in setups]), reps=1, warmup=False)
    plain_dense = [maxplus_fold_many_ref(**a) for a in dense_setups]
    for route, got, want in (("compact", kern, plain[0]),
                             ("dense", kern_dense, plain_dense)):
        for k, p_ in zip(got, want):
            if not torch.equal(k.view(torch.int32), p_.view(torch.int32)):
                raise AssertionError(
                    f"many-trace kernel ({route} route) != plain on the "
                    f"fleet (max abs {float((k - p_).abs().max())})")
    del plain_dense, kern_dense
    groups_t = [time_many(a, k) for a, k in zip(setups, kern)]
    b_ms, b_by = bound_ms(sum(g["bytes"] for g in groups_t),
                          sum(g["operations"] for g in groups_t))
    old_ms = bound_ms(sum(g["bytes"] for g in groups_t),
                      sum(g["operations_dense_count"] for g in groups_t))[0]
    for name, a, g in zip(("8x16", "4x8"), setups, groups_t):
        log(f"[6] {name} group: B={a['idx'].shape[0]} "
            f"M1={a['mats'].shape[0]} N={a['mats'].shape[1]} "
            f"T={a['idx'].shape[1]}, {int(a['lengths'].sum())} steps, "
            f"dictionary {a['mats'].numel() * 4 / 1e6:.1f} MB, arrivals "
            f"{a['with_arrivals']}, faults {a['extras'] is not None}; "
            f"compact route {g['ms']:.3f} ms (pre-pass {g['prepass_ms']:.4f}"
            f" ms, fold alone {g['fold_ms']:.3f} ms; {g['lane_warps']} lanes"
            f" a block; longest lane "
            f"{g['longest_lane']} steps at {g['ns_per_step']:.1f} ns a "
            f"step), dense route {g['dense_ms']:.3f} ms; bound "
            f"{g['bound_ms']:.4f} ms ({g['bound_by']}; the dense count "
            f"{g['bound_ms_dense_count']:.4f} ms)")
    log(f"[6] many-trace kernel bit-equal to its plain version on the whole "
        f"fleet through both routes; compact route {k_ms:.3f} ms for both "
        f"launches, dense route {sum(g['dense_ms'] for g in groups_t):.3f} "
        f"ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; the dense "
        f"count {old_ms:.4f} ms)")
    group_ms = [g["ms"] for g in groups_t]

    # -- per-trace K1 on 8 lanes, the scan engine, the oracle -----------
    lanes = list(range(8))
    per = [sim.run(fleet[i], engine="cuda").end_us for i in lanes]
    if per != [ends[i] for i in lanes]:
        raise AssertionError(f"run_many(cuda) != per-trace run(cuda) on 8 "
                             f"lanes: {per} vs {[ends[i] for i in lanes]}")
    short = [i for i, t in enumerate(fleet) if t.n_ops <= FLEET_SCAN_OPS]
    if not (short[0] < len(groups[0]) <= short[-1]):
        raise AssertionError("the scan check's traces miss a geometry group")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan_res = sim.run_many([fleet[i] for i in short], engine="scan")
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t0
    shares = [abs(s_.end_us - ends[i]) / ends[i]
              / (fleet[i].n_ops * F32_DRIFT_PER_OP)
              for s_, i in zip(scan_res, short)]
    if max(shares) > 1.0:
        raise AssertionError(f"run_many scan vs cuda: {max(shares):.2f} of "
                             "the T*2^-24 bar")
    dyadic = timing_columns(sim.table, lambda q, c: np.round(c / DYADIC_US)
                            * DYADIC_US)
    exact = [dataclasses.replace(
        fleet[i], **{f: (None if getattr(fleet[i], f) is None else
                         (np.round(getattr(fleet[i], f) / DYADIC_US)
                          * DYADIC_US).astype(np.float32))
                     for f in ("arrival_us", "extra_us")}) for i in (0, 1)]
    got = Simulator(table=dyadic).run_many(exact, engine="cuda")
    oracle_err = max(rel(r.end_us, simulate_trace_ref(dyadic, t))
                     for r, t in zip(got, exact))
    if oracle_err > REL_TOL_ORACLE:
        raise AssertionError(f"fleet lanes vs oracle: {oracle_err:.2e}")
    log(f"[6] run_many(cuda) bit-equal to per-trace run(cuda) on lanes "
        f"{lanes}; run_many(scan) on the {len(short)} traces of at most "
        f"{FLEET_SCAN_OPS} ops {scan_wall:.1f} s wall, at most "
        f"{max(shares):.2f} of the T*2^-24 bar from cuda; lanes 0 (arrivals)"
        f" and 1 (surcharges) vs the numpy oracle on {DYADIC_US} us-dyadic "
        f"timing: {oracle_err:.2e} (< {REL_TOL_ORACLE})")
    return {"launches": launches["many"], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0,
            "routes": {
                "compact": {"launches": launches["many/compact"],
                            "ms": k_ms,
                            "prepass_ms": sum(g["prepass_ms"]
                                              for g in groups_t),
                            "fold_ms": sum(g["fold_ms"] for g in groups_t),
                            "ns_per_step": [g["ns_per_step"]
                                            for g in groups_t]},
                "dense": {"launches": launches["many/dense"],
                          "ms": sum(g["dense_ms"] for g in groups_t),
                          "max_abs_err": 0.0}},
            "bound_ms_dense_count": old_ms,
            "groups": [{k: v for k, v in g.items()} for g in groups_t],
            "group_ms": group_ms,
            "cuda_wall_s": cuda_wall, "scan_wall_s": scan_wall,
            "scan_traces": len(short),
            "n_traces": len(fleet), "n_ops": total_ops,
            "oracle_rel_err_dyadic": oracle_err}


# ---------------------------------------------------------------------------
# phase 7: sweeps, streaming and calibration
# ---------------------------------------------------------------------------


def stream_peaks(sim, n_ops, chunk):
    """(result, wall s, host peak bytes, device peak bytes) of one
    ``run_stream`` over ``mixed_trace_chunks``; the device peak is counted
    above what was allocated before the stream started, the host peak is
    taken by tracemalloc in a second pass, so the wall time is
    untraced."""
    import torch
    from repro_torch.core.trace import mixed_trace_chunks

    def chunks():
        return mixed_trace_chunks(n_ops, STREAM_CHANNELS, STREAM_WAYS, 0.7,
                                  chunk_len=chunk, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = sim.run_stream(chunks())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev_peak = torch.cuda.max_memory_allocated() - before
    tracemalloc.start()
    again = sim.run_stream(chunks())
    host_peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    if again.end_us != res.end_us:
        raise AssertionError("run_stream is not deterministic")
    return res, wall, host_peak, dev_peak


def phase_sweeps_streams(tables, trace, sweep_ends) -> dict:
    import numpy as np
    from repro_torch.api import (Simulator, steady_channel_bandwidth_mb_s,
                                 sweep_steady_bandwidth_mb_s)
    from repro_torch.core import calibrate
    from repro_torch.core.interface import InterfaceKind, make_interface
    from repro_torch.core.nand import MLC, SLC, CellType
    from repro_torch.core.paper_tables import INTERFACE_ORDER
    from repro_torch.core.sim import SSDConfig, page_op_params
    from repro_torch.core.trace import mixed_trace

    t0 = time.perf_counter()
    sess = Simulator(SSDConfig(channels=SWEEP_CHANNELS, ways=SWEEP_WAYS))
    again = sess.sweep(tables, trace, engine="cuda")
    if not np.array_equal(again, sweep_ends):
        raise AssertionError("Simulator.sweep != phase 5's sweep_tables")
    sweep_s = time.perf_counter() - t0

    cells = [(w, k) for w in calibrate.WAYS for k in INTERFACE_ORDER]
    ops = [page_op_params(make_interface(InterfaceKind(k)), SLC, "write", w)
           for w, k in cells]
    cols = [np.asarray([float(getattr(op, f)) for op in ops])
            for f in calibrate._OP_FIELDS]
    ways = np.asarray([w for w, _ in cells], np.int32)
    swept = sweep_steady_bandwidth_mb_s(*cols, ways)
    per = np.asarray([steady_channel_bandwidth_mb_s(op, w)
                      for op, (w, _) in zip(ops, cells)], np.float32)
    if not np.array_equal(swept, per):
        raise AssertionError(f"sweep_steady_bandwidth_mb_s != per-point "
                             f"channel bandwidth: {swept} vs {per}")
    log(f"[7] Simulator.sweep == sweep_tables on {len(tables)} points "
        f"({sweep_s:.1f} s); sweep_steady_bandwidth_mb_s == per-point "
        f"steady_channel_bandwidth_mb_s (float32) on {len(cells)} Table 3 "
        f"SLC write cells")

    t0 = time.perf_counter()
    fit = calibrate.fit_slc()
    fit_s = time.perf_counter() - t0
    if fit != REFERENCE_FIT_SLC:
        raise AssertionError(f"fit_slc {fit} != the JAX package's "
                             f"{REFERENCE_FIT_SLC}")
    stripes = calibrate.stripe_crosscheck()
    log(f"[7] fit_slc in {fit_s:.1f} s: t_prog {fit[0]} us, t_poll "
        f"{fit[1]} cycles, write MAE {fit[2]:.4f} (the JAX package's fit; "
        f"frozen nand.SLC t_prog {SLC.t_prog_lo_us} us); stripe exponents "
        + ", ".join(f"{c}/{m} C**{x:.3f}" for (c, m), x in stripes.items()))

    mlc = Simulator(SSDConfig(cell=CellType.MLC, channels=STREAM_CHANNELS,
                              ways=STREAM_WAYS))
    whole = mixed_trace(STREAM_CHECK_OPS, STREAM_CHANNELS, STREAM_WAYS, 0.7,
                        seed=0)
    t0 = time.perf_counter()
    scan = mlc.run(whole, engine="scan")
    scan_s = time.perf_counter() - t0
    short, short_s, short_host, short_dev = stream_peaks(
        mlc, STREAM_CHECK_OPS, STREAM_CHECK_CHUNK)
    if short.end_us != scan.end_us or short.n_ops != STREAM_CHECK_OPS:
        raise AssertionError(f"run_stream {short.end_us} != run(scan) "
                             f"{scan.end_us} on {STREAM_CHECK_OPS} ops")
    long_, long_s, long_host, long_dev = stream_peaks(
        mlc, STREAM_OPS, STREAM_CHUNK)
    if not (np.isfinite(long_.end_us) and long_.end_us > short.end_us
            and long_.n_ops == STREAM_OPS):
        raise AssertionError(f"long stream malformed: {long_.describe()}")
    log(f"[7] run_stream on {STREAM_CHANNELS}x{STREAM_WAYS} "
        f"{MLC.cell.value}: {STREAM_CHECK_OPS} ops (chunk "
        f"{STREAM_CHECK_CHUNK}) bit-equal to run(scan) on the materialised "
        f"trace ({short_s:.1f} s vs {scan_s:.1f} s); {STREAM_OPS} ops "
        f"(chunk {STREAM_CHUNK}) in {long_s:.1f} s, "
        f"{STREAM_OPS / long_s:.0f} ops/s; host peak "
        f"{long_host / 1e6:.2f} MB vs {short_host / 1e6:.2f} MB, device "
        f"peak {long_dev / 1e6:.2f} MB vs {short_dev / 1e6:.2f} MB")
    return {"sweep_s": sweep_s, "fit_slc": list(fit), "fit_slc_s": fit_s,
            "stripe": {f"{c}/{m}": x for (c, m), x in stripes.items()},
            "stream_ops_per_s": STREAM_OPS / long_s,
            "stream_wall_s": long_s, "stream_check_wall_s": short_s,
            "scan_wall_s": scan_s,
            "stream_host_peak_mb": [short_host / 1e6, long_host / 1e6],
            "stream_device_peak_mb": [short_dev / 1e6, long_dev / 1e6]}


# ---------------------------------------------------------------------------
# phase 8: LM serving — RecurrentGemma-9B through the flash-attention (K4)
# and RG-LRU scan (K5) kernels
# ---------------------------------------------------------------------------


def flash_small_cases():
    """(b, h, kvh, sq, sk, d, causal, window, dtype): the JAX package's
    tests/test_kernels.py FLASH_CASES, then ragged S (100, 1000), D = 256
    with MQA and S > window, queries offset past a window, and a window
    without the causal mask."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    return [(2, 4, 2, 128, 128, 64, True, None, f32),
            (1, 4, 1, 256, 256, 64, True, 64, f32),
            (2, 2, 2, 128, 128, 32, False, None, bf16),
            (1, 6, 2, 128, 256, 64, True, None, f32),
            (1, 8, 8, 64, 64, 128, True, None, f32),
            (1, 2, 1, 64, 64, 16, True, 16, bf16),
            (2, 4, 1, 100, 100, 64, True, 37, f32),
            (1, 3, 3, 1000, 1000, 128, True, None, bf16),
            (2, 16, 1, 300, 300, 256, True, 128, bf16),
            (1, 16, 1, 257, 257, 256, True, 64, f32),
            (4, 16, 1, 1000, 1000, 256, True, 512, bf16),
            (1, 4, 2, 70, 200, 64, True, 50, f32),
            (1, 2, 1, 96, 96, 64, False, 20, f32)]


def flash_err(got, want) -> float:
    """max |kernel - plain| over max(1, max |plain|)."""
    err = float((got.float() - want.float()).abs().max())
    return err / max(1.0, float(want.float().abs().max()))


def rglru_ring_cases() -> list:
    """(b, s, r, dtype) the ring route of K5 takes, at its edges: for each
    (b, r, dtype), S = 1, Tc - 1, Tc, Tc + 1 and 5 stages plus a ragged
    tail of 7, with Tc the plan's steps a stage; the channel tile C is
    128, 64 and 32 in each dtype, and R is a multiple of C or not.  Then
    six earlier shapes (ragged S, R not a multiple of 128)."""
    import torch
    from repro_torch.kernels.rglru import plan as RP
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for b, r, dtype in ((4, 4096, f32), (2, 4040, f32), (1, 4096, f32),
                        (2, 200, f32), (40, 520, f32), (4, 4096, bf16),
                        (2, 4040, bf16), (3, 200, bf16)):
        tc = RP.ring_plan(b, 1, r, dtype.itemsize).steps
        cases += [(b, s, r, dtype) for s in (1, tc - 1, tc, tc + 1,
                                             5 * tc + 7)]
    return cases + [(2, 512, 128, f32), (3, 37, 100, f32), (2, 129, 200, bf16),
                    (1, 4096, 64, f32), (4, 1, 4096, bf16),
                    (2, 1000, 4096, f32)]


def rglru_inputs(b, s, r, dtype, seed, device, offset=0):
    """a in [0.85, 0.999) and b normal, [b, s, r] in dtype; with
    ``offset``, views that many elements into their storage."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    xs = [(0.85 + 0.149 * torch.rand((b, s, r), generator=g,
                                     device=device)).to(dtype),
          torch.randn((b, s, r), generator=g, device=device).to(dtype)]
    if offset:
        bufs = [torch.empty(b * s * r + offset, dtype=dtype, device=device)
                for _ in xs]
        xs = [buf[offset:].view(b, s, r).copy_(x) for buf, x in zip(bufs, xs)]
    return xs


def check_rglru_small(device) -> dict:
    """8a for K5: both routes bit-equal to ``rglru_scan_ref``.  Through the
    wrapper, the ring cases (``rglru_ring_cases``) must take the ring and
    four inputs TMA cannot read must take the simple route (R * itemsize
    not a multiple of 16 bytes; views at storage offset 1, in f32 and
    bf16)."""
    import torch
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import plan as RP
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    ring = rglru_ring_cases()
    simple = [(2, 77, 37, torch.float32, 0), (2, 300, 100, torch.bfloat16, 0),
              (2, 129, 64, torch.float32, 1), (3, 70, 4096, torch.bfloat16, 1)]
    RK.reset_launches()
    for i, (b, s, r, dtype, off) in enumerate(
            [c + (0,) for c in ring] + simple):
        a, x = rglru_inputs(b, s, r, dtype, 100 + i, device, off)
        want = rglru_scan_ref(a, x)
        if not torch.equal(RK.rglru_scan_kernel(a, x), want):
            raise AssertionError(f"rglru kernel != plain at {(b, s, r, dtype)}"
                                 f", storage offset {off}")
    n_ring, n_simple = len(ring), len(simple)
    want_launches = {RK.TOTAL: n_ring + n_simple,
                     RK.ROUTE_KEYS[RP.RING]: n_ring,
                     RK.ROUTE_KEYS[RP.SIMPLE]: n_simple}
    if RK.LAUNCHES != want_launches:
        raise AssertionError(f"8a launched {RK.LAUNCHES} RG-LRU scans, "
                             f"expected {want_launches}")
    log(f"[8a] RG-LRU scan kernel bit-equal to plain: the ring route on "
        f"{len(ring)} shapes (S = 1, Tc - 1, Tc, Tc + 1, 5 Tc + 7; C = 128, "
        f"64, 32; R ragged; B > 1; f32 and bf16), the simple route on "
        f"{n_simple} "
        f"inputs TMA cannot read (R = 37 f32, R = 100 bf16, storage offset "
        f"1 in f32 and bf16); launches {RK.LAUNCHES}")
    return {"ring_shapes": len(ring), "simple_inputs": n_simple,
            "launches": dict(RK.LAUNCHES)}


def phase_lm_small(device) -> dict:
    """8a: K4 and K5 against their plain versions at small shapes, and
    the SMOKE model served on the card against the CPU's plain path."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.recurrentgemma_9b import SMOKE
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServingEngine

    # every case through both routes: its own dtype, and a copy in the
    # other (bf16 -> the tensor-core kernel, f32 -> the CUDA-core kernel)
    worst = {str(torch.float32): 0.0, str(torch.bfloat16): 0.0}
    FK.reset_launches()
    for i, (b, h, kvh, sq, sk, d, causal, window, dtype) in enumerate(
            flash_small_cases()):
        g = torch.Generator(device=device).manual_seed(i)
        xs = [torch.randn(shape, generator=g, device=device)
              for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))]
        off = sk - sq if causal else 0
        for dt in (dtype, torch.bfloat16 if dtype == torch.float32
                   else torch.float32):
            q, k, v = (x.to(dtype).to(dt) for x in xs)
            got = FK.flash_attention_bhsd(q, k, v, causal=causal,
                                          window=window, q_offset=off)
            want = attention_reference(q, k, v, causal=causal, window=window,
                                       q_offset=off)
            torch.cuda.synchronize()
            err = flash_err(got, want)
            if err > FLASH_TOL[str(dt)]:
                raise AssertionError(
                    f"flash kernel case {i} (b {b} h {h} kvh {kvh} sq {sq} "
                    f"sk {sk} d {d} causal {causal} window {window} {dt}, "
                    f"route {FK.route(dt)}): {err:.2e} > "
                    f"{FLASH_TOL[str(dt)]}")
            worst[str(dt)] = max(worst[str(dt)], err)
    n_cases = len(flash_small_cases())
    if FK.LAUNCHES != {FK.TC: n_cases, FK.F32: n_cases}:
        raise AssertionError(f"8a launched {FK.LAUNCHES}, expected "
                             f"{n_cases} of each route")
    log(f"[8a] flash-attention kernels vs plain on {n_cases} shapes, each "
        f"through both routes ({FK.LAUNCHES}): worst relative error "
        + ", ".join(f"{w:.2e} ({k}, bar {FLASH_TOL[k]})"
                    for k, w in worst.items()))

    k5 = check_rglru_small(device)

    cfg = dataclasses.replace(SMOKE, compute_dtype="f32")
    cpu_p = init_params(cfg, 0, device="cpu")
    card_p = to_device(cpu_p, device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (21, 17, 9)]
    got = ServingEngine(cfg, card_p, max_seq=40).generate(prompts, 12)
    want = ServingEngine(cfg, cpu_p, max_seq=40, device="cpu").generate(
        prompts, 12)
    lerr = float(np.max(np.abs(got.prefill_logits - want.prefill_logits)))
    lscale = float(np.max(np.abs(want.prefill_logits)))
    if not np.array_equal(got.tokens, want.tokens) or lerr > 1e-4 * lscale:
        raise AssertionError(f"SMOKE served on the card differs from the CPU"
                             f" plain path: logits {lerr:.2e} of {lscale:.1f}")
    log(f"[8a] {cfg.name} (f32 compute) generate on the card: 12 greedy "
        f"tokens x 3 prompts identical to the CPU plain path, prefill "
        f"logits within {lerr:.2e} (bar 1e-4 x {lscale:.1f})")
    return {"flash_small_worst_rel": worst, "k5_small": k5}


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def valid_pairs(sq: int, sk: int, causal: bool, window, q_offset: int) -> int:
    """(q, k) pairs the mask keeps, per (batch, head)."""
    import numpy as np
    q = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


class CellLaunches:
    """Wraps a module's trace-indexed fold entry point; counts its launches
    by geometry (B, M, N, T, energy) and keeps clones of the first call's
    arguments of each."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.by_shape = {}
        setattr(module, name, self)

    def __call__(self, mats, s0, **kwargs):
        if kwargs.get("idx") is not None:
            b, m, n, _ = mats.shape
            key = (b, m, n, kwargs["t_steps"],
                   kwargs.get("energy") is not None)
            count, args, kw = self.by_shape.get(key, (0, None, None))
            if args is None:
                args = (mats.clone(), s0.clone())
                kw = {k: v.clone() if hasattr(v, "clone") else v
                      for k, v in kwargs.items()}
            self.by_shape[key] = (count + 1, args, kw)
        return self.fn(mats, s0, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def wall_ms(fn, reps: int = 3) -> float:
    """Median host-clock time (ms) of ``fn`` and a synchronise."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def compact_fold_ms(rec, mats, s0, kwargs) -> float:
    """Device time of the compact K1/K2 fold alone, launched through the
    C interface on the pre-pass's records ``rec`` (the wrapper adds the
    pre-pass and the read of its flag)."""
    import torch
    from repro_torch.kernels.maxplus import kernel as K
    lib, ptr = K._library(), K._ptr
    b, m, n, _ = mats.shape
    t = kwargs["t_steps"]
    idx, energy = kwargs.get("idx"), kwargs.get("energy")
    idx = None if idx is None else idx[:t]
    arr, ext = kwargs.get("arrivals"), kwargs.get("extras")
    if any(kwargs.get(k) is not None for k in ("arrivals", "extras", "gvec",
                                                 "wvec")):
        zeros = torch.zeros((t,), device=mats.device)
        arr = zeros if arr is None else arr[:t]
        ext = zeros if ext is None else ext[:t]
    p = 0 if energy is None else energy.shape[-1]
    out = torch.empty((b, n), device=mats.device)
    acc = torch.empty((b, max(p, 1)), device=mats.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.maxplus_fold_compact(
            ptr(rec), ptr(s0), ptr(idx), ptr(arr), ptr(ext), ptr(energy),
            ptr(out), ptr(acc) if p else None, b, m, n, p, t, stream)
        K._raise_on(lib, rc, "maxplus_fold_compact")
    return cuda_ms(launch)


def compact_many_ms(rec, args) -> float:
    """Device time of the compact K3 fold alone (see ``compact_fold_ms``)."""
    import torch
    from repro_torch.kernels.maxplus import kernel as K
    lib, ptr = K._library(), K._ptr
    m1, n, _ = args["mats"].shape
    b, t = args["idx"].shape
    out = torch.empty((b, n), device=args["mats"].device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.maxplus_fold_many_compact(
            ptr(rec), ptr(args["idx"]),
            ptr(args["arrivals"]) if args["with_arrivals"] else None,
            ptr(args["extras"]), ptr(args["s0"]), ptr(args["lengths"]),
            ptr(out), b, m1, n, t, stream)
        K._raise_on(lib, rc, "maxplus_fold_many_compact")
    return cuda_ms(launch)


def time_fold(mats, s0, kwargs, dense: bool = True) -> dict:
    """One K1/K2 launch of ``maxplus_fold_kernel(mats, s0, **kwargs)``
    timed through both routes (the dense one on ``refused_s0(s0)``; not
    with ``dense=False``), the pre-pass alone, the compact fold alone and
    its ns a step, the host wall of one call and of the pre-pass with its
    flag read, and its bounds: counted for what the inputs need and by
    the dense count."""
    import torch
    from repro_torch.kernels.maxplus import kernel as K
    t = kwargs["t_steps"]
    before = dict(K.LAUNCHES)
    out = K.maxplus_fold_kernel(mats, s0, **kwargs)
    branch = "periodic" if kwargs.get("idx") is None else "indexed"
    if route_delta(before, branch)["compact"] != 1:
        raise AssertionError(f"{branch} fold at B={mats.shape[0]} "
                             f"M={mats.shape[1]} N={mats.shape[2]} T={t} "
                             "did not take the compact route")
    ms = cuda_ms(lambda: K.maxplus_fold_kernel(mats, s0, **kwargs))
    dense_s0 = refused_s0(s0)
    dense_ms = cuda_ms(lambda: K.maxplus_fold_kernel(
        mats, dense_s0, **kwargs)) if dense else None
    side = {k: kwargs.get(k) for k in ("gvec", "wvec")}
    values = {k: kwargs.get(k) for k in ("arrivals", "extras")}
    if values["arrivals"] is not None:
        values = {k: v[:t] for k, v in values.items()}
    pre_ms = cuda_ms(lambda: K.maxplus_compact_kernel(mats, **side, s0=s0,
                                                      **values))
    flag_ms = wall_ms(lambda: int(K.maxplus_compact_kernel(
        mats, **side, s0=s0, **values)[1]))
    rec, _ = K.maxplus_compact_kernel(mats, **side, s0=s0, **values)
    fold_ms = compact_fold_ms(rec, mats, s0, kwargs)
    host_ms = wall_ms(lambda: K.maxplus_fold_kernel(mats, s0, **kwargs))
    outs = out if isinstance(out, tuple) else (out,)
    energy = kwargs.get("energy")
    inputs = [x for x in (s0, kwargs.get("idx"), energy, *values.values())
              if x is not None]
    by, ops_, old_ops = fold_work(mats, t, inputs, outs, idx=kwargs.get("idx"),
                                  p=0 if energy is None else energy.shape[-1],
                                  **side)
    b_ms, b_by = bound_ms(by, ops_)
    old_ms, _ = bound_ms(by, old_ops)
    return {"ms": ms, "dense_ms": dense_ms, "prepass_ms": pre_ms,
            "fold_ms": fold_ms, "host_ms": host_ms, "flag_wall_ms": flag_ms,
            "ns_per_step": fold_ms * 1e6 / t if t else None,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_dense_count": old_ms,
            "bytes": by, "operations": ops_, "operations_dense_count": old_ops,
            "out": out}


def time_cell_launches(cells: "CellLaunches", expected: int) -> dict:
    """One launch of each recorded geometry timed (``time_fold``); their
    sum over all the launches, bound and launches x (time - bound)."""
    total = bound = loss = dense = pre = fold = old_bound = 0.0
    geoms = []
    for key, (count, args, kwargs) in sorted(cells.by_shape.items()):
        f = time_fold(*args, kwargs)
        total += count * f["ms"]
        dense += count * f["dense_ms"]
        pre += count * f["prepass_ms"]
        fold += count * f["fold_ms"]
        bound += count * f["bound_ms"]
        old_bound += count * f["bound_ms_dense_count"]
        loss += count * (f["ms"] - f["bound_ms"])
        geoms.append(f"{count}x(B={key[0]} M={key[1]} N={key[2]} "
                     f"T={key[3]}{' energy' if key[4] else ''}: "
                     f"{f['ms']:.4f} ms (pre-pass {f['prepass_ms']:.4f}, "
                     f"fold alone {f['fold_ms']:.4f}, "
                     f"{f['ns_per_step']:.1f} ns a step; host wall "
                     f"{f['host_ms']:.4f}, of the pre-pass and its flag "
                     f"read {f['flag_wall_ms']:.4f}), dense "
                     f"{f['dense_ms']:.3f}, "
                     f"bound {f['bound_ms']:.6f} ({f['bound_by']}))")
    n = sum(c for c, _, _ in cells.by_shape.values())
    if n != expected:
        raise AssertionError(f"{n} Table-cell launches recorded, the "
                             f"counter says {expected}")
    log(f"[5] K1 Table-cell launches of phase 4: {n} in {len(geoms)} "
        f"geometries, one of each timed: compact route {total:.3f} ms in "
        f"all (pre-passes {pre:.3f} ms, folds alone {fold:.3f} ms), dense "
        f"route {dense:.2f} ms; bound "
        f"{bound:.5f} ms (the dense count: {old_bound:.5f}), launches x "
        f"(time - bound) {loss:.3f} ms")
    log("[5] K1 Table-cell geometries: " + "; ".join(geoms))
    return {"launches": n, "geometries": len(geoms), "ms": total,
            "dense_ms": dense, "prepass_ms": pre, "fold_ms": fold,
            "bound_ms": bound,
            "bound_ms_dense_count": old_bound, "loss_ms": loss}


class CallMemory:
    """Device memory of one call, for phase 15a: the bytes its argument
    tensors hold (numel x element size) and the call's own rise, the peak
    of ``memory_allocated`` after a ``reset_peak_memory_stats()`` just
    before the call less what was allocated just before.  Clones that this
    script's recorders make during the call (``instrument()``) are taken
    out exactly: the rise is the largest of the peak before each clone and
    the final peak, each less the clones held by then.  ``prior_peak`` is
    the peak before the reset, so that a phase's own peak can still span
    the call."""

    active = None

    def __init__(self, *args):
        import torch
        from torch.utils._pytree import tree_leaves
        self.arg_bytes = sum(t.numel() * t.element_size()
                             for t in tree_leaves(args)
                             if isinstance(t, torch.Tensor))
        torch.cuda.synchronize()
        self.prior_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.base = torch.cuda.memory_allocated()
        self.held, self.peaks = 0, []
        CallMemory.active = self

    @staticmethod
    @contextlib.contextmanager
    def instrument():
        """Allocations made inside are the script's, not the call's."""
        import torch
        mem = CallMemory.active
        if mem is None:
            yield
            return
        mem.peaks.append(torch.cuda.max_memory_allocated() - mem.held)
        before = torch.cuda.memory_allocated()
        yield
        mem.held += torch.cuda.memory_allocated() - before

    def done(self) -> dict:
        import torch
        torch.cuda.synchronize()
        CallMemory.active = None
        peak = torch.cuda.max_memory_allocated()
        return {"arg_bytes": self.arg_bytes,
                "rise": max(self.peaks + [peak - self.held]) - self.base,
                "instrument_bytes": self.held,
                "peak_gb": max(self.prior_peak, peak) / 1e9}


class Recorder:
    """Wraps a module's kernel entry point; keeps clones of the first
    call's tensor arguments and its keywords but the destination and the
    lse request (the calls it is replayed with take neither)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = self.kwargs = None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.args is None:
            with CallMemory.instrument():
                self.args = [a.clone() for a in args]
            self.kwargs = {k: v for k, v in kwargs.items()
                           if k not in ("out", "with_lse")}
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def kernel_resources(ptxas: str, pattern: str) -> tuple[str, str]:
    """(registers, spill line) that ptxas reported for the entry function
    whose mangled name holds ``pattern``."""
    lines = ptxas.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and pattern in ln:
            regs = spill = "?"
            for nxt in lines[i + 1:i + 6]:
                if "spill" in nxt:
                    spill = nxt.strip()
                if "Used" in nxt and "registers" in nxt:
                    regs = nxt.split("Used")[1].split("registers")[0].strip()
                    break
            return regs, spill
    return "?", "?"


def ring_kernel_name(dtype, p) -> str:
    """The part of K5's ring kernel's mangled name that ptxas reports for
    the instantiation of plan ``p``."""
    import torch
    t = "f" if dtype == torch.float32 else "13__nv_bfloat16"
    return f"rglru_scan_ringI{t}Li{p.channels}ELi{p.steps}ELi{p.stages}EE"


def time_rglru(a, b) -> dict:
    """K5 at one shape: the ring as planned, the simple route, and
    ``torch.add(a, b, out=h)`` on the same tensors (the same bytes, not
    the same function), each as one call (``cuda_ms``) and by
    ``queued_ms``; the bytes bound.  Where a, b and h fit the L2
    L2_ROTATE times over, the calls rotate over that many copies."""
    import itertools

    import torch
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import plan as RP
    shape, size = tuple(a.shape), a.element_size()
    n_bytes = 3.0 * a.numel() * size
    n_copies = max(1, -(-L2_ROTATE * L2_BYTES // int(n_bytes)))
    sets = [(a, b, torch.empty_like(a))] + [
        (a.clone(), b.clone(), torch.empty_like(a))
        for _ in range(n_copies - 1)]
    plans = {RP.plan(*shape, size, (x.data_ptr(), y.data_ptr(), h.data_ptr()))
             for x, y, h in sets}
    p = RP.ring_plan(*shape, size)
    if plans != {p}:
        raise AssertionError(f"K5 at {shape} planned {plans}, not the ring")

    def rotated(fn):
        it = itertools.cycle(sets)
        return lambda: fn(*next(it))

    t = {}
    for name, q in (("ring", p), ("simple", RP.simple_plan(*shape))):
        t[f"{name}_ms"] = cuda_ms(rotated(lambda x, y, h, q=q:
                                          RK.launch(x, y, h, q)))
        t[f"{name}_queued_ms"] = queued_ms(rotated(lambda x, y, h, q=q:
                                                   RK.launch(x, y, h, q)))
    add = rotated(lambda x, y, h: torch.add(x, y, out=h))
    t["add_ms"], t["add_queued_ms"] = cuda_ms(add), queued_ms(add)
    t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, 2.0 * a.numel())
    return {**t, "bytes": n_bytes, "plan": p, "copies": n_copies,
            "shape": shape, "dtype": str(a.dtype)}


def lm_params(cfg, device) -> tuple:
    """Random parameters of ``cfg`` on the card from LM_SEED; (params,
    count, bytes, seconds)."""
    import torch
    from repro_torch.models.transformer import init_params, param_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        LM_SEED), device=device)
    torch.cuda.synchronize()
    n_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    return params, param_count(params), n_bytes, time.perf_counter() - t0


def serve_wave(cfg, params, device) -> dict:
    """Phase 8b's wave through ``ServingEngine.generate`` with the launch
    counts reset just before and read just after; the prefill timed
    apart; the first K4 launch recorded."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.serve import ServingEngine
    from repro_torch.serve import engine as engine_mod

    rng = np.random.default_rng(LM_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in LM_PROMPT_LENS]
    eng = ServingEngine(cfg, params, max_seq=LM_MAX_SEQ)
    prefill_s, prefill_mem = [], []
    real_prefill = engine_mod.prefill

    def timed_prefill(*a, **kw):
        mem = CallMemory(a, kw)
        t = time.perf_counter()
        res = real_prefill(*a, **kw)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t)
        prefill_mem.append(mem.done())
        return res

    rec = Recorder(flash_ops, "flash_attention_bhsd")
    engine_mod.prefill = timed_prefill
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FK.reset_launches()
        RK.reset_launches()
        t0 = time.perf_counter()
        res = eng.generate(prompts, n_new=LM_NEW_TOKENS)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = {**FK.LAUNCHES, **RK.LAUNCHES}
        # the peak of the whole wave (the prefill's reset folded back in)
        peak_gb = max(prefill_mem[0]["peak_gb"],
                      torch.cuda.max_memory_allocated() / 1e9)
    finally:
        CallMemory.active = None
        rec.restore()
        engine_mod.prefill = real_prefill
    b = len(prompts)
    toks, logits = res.tokens, res.prefill_logits
    if not (toks.shape == (b, LM_NEW_TOKENS) and toks.min() >= 0
            and toks.max() < cfg.vocab_size
            and logits.shape == (b, cfg.padded_vocab)
            and np.all(np.isfinite(logits[:, :cfg.vocab_size]))
            and np.array_equal(toks[:, 0], logits.argmax(-1))):
        raise AssertionError(f"{cfg.name}: generate returned malformed "
                             "tokens or logits")
    decode_s = gen_s - prefill_s[0]
    return {"launches": launches, "k4_args": rec.args,
            "k4_kwargs": rec.kwargs, "generate_s": gen_s,
            "prefill_s": prefill_s[0], "decode_s": decode_s,
            "decode_tokens_per_s": b * (LM_NEW_TOKENS - 1) / decode_s,
            "peak_device_gb": peak_gb, "prefill_memory": prefill_mem[0]}


def log_wave(label: str, wave: dict) -> None:
    log(f"[{label}] ServingEngine(max_seq={LM_MAX_SEQ}).generate: "
        f"{len(LM_PROMPT_LENS)} prompts of "
        f"{'/'.join(map(str, LM_PROMPT_LENS))} tokens left-padded to "
        f"{max(LM_PROMPT_LENS)} + {LM_NEW_TOKENS} greedy tokens in "
        f"{wave['generate_s']:.2f} s: prefill {wave['prefill_s']:.3f} s, "
        f"decode {wave['decode_s']:.3f} s "
        f"({wave['decode_tokens_per_s']:.1f} tokens/s, "
        f"{wave['decode_s'] / (LM_NEW_TOKENS - 1) * 1e3:.1f} ms a step); "
        f"peak device memory {wave['peak_device_gb']:.2f} GB; launches "
        f"{wave['launches']}")


def time_k4(q, k, v, kw, out) -> dict:
    """K4 at one shape: one call between CUDA events (median of 3), its
    plain version, the CUDA-core route on f32 copies of the inputs, and
    ``scaled_dot_product_attention`` on the same inputs (kv heads repeated
    to the query heads) with the mask as a boolean ``attn_mask`` and,
    where there is no window, with ``is_causal=True``; the bound, for the
    (q, k) pairs the mask keeps, and the flops each route's tile plan
    computes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import tiles as flash_tiles
    from repro_torch.kernels.flash_attention.ref import attention_reference

    t = {"ms": cuda_ms(lambda: FK.flash_attention_bhsd(q, k, v, **kw)),
         "plain_ms": cuda_ms(lambda: attention_reference(q, k, v, **kw),
                             warmup=False)}
    qf, kf, vf = q.float(), k.float(), v.float()
    t["f32_route_ms"] = cuda_ms(lambda: FK.flash_attention_bhsd(qf, kf, vf,
                                                                **kw))
    del qf, kf, vf
    bq, hq, sq, d = q.shape
    group = hq // k.shape[1]
    k_rep = k.repeat_interleave(group, dim=1)
    v_rep = v.repeat_interleave(group, dim=1)
    pos = torch.arange(sq, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if kw.get("window"):
        mask &= (pos[:, None] - pos[None, :]) < kw["window"]
    t["library_ms"] = t["sdpa_is_causal_ms"] = None
    try:             # the yardstick only, never the path
        t["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k_rep, v_rep, attn_mask=mask))
        if not kw.get("window"):
            t["sdpa_is_causal_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k_rep, v_rep,
                                                       is_causal=True))
    except RuntimeError as exc:
        log(f"SDPA yardstick failed: {exc}")
    del k_rep, v_rep, mask
    t["pairs"] = valid_pairs(sq, k.shape[2], kw.get("causal", True),
                             kw.get("window"), kw.get("q_offset", 0))
    t["bytes"] = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    t["ops"] = 4.0 * d * t["pairs"] * bq * hq
    t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["ops"], ops_per_s=(
        BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S))
    plan = {"sq": sq, "sk": k.shape[2], "causal": kw.get("causal", True),
            "window": kw.get("window"), "q_offset": kw.get("q_offset", 0)}
    for key, name in (("computed_flops", FK.TC), ("f32_computed_flops",
                                                  FK.F32)):
        tq, tk = FK.tile(name, d)
        t[key] = flash_tiles.computed_flops(bq, hq, d, bq=tq, bk=tk, **plan)
    return t


def phase_lm_serve(device, flash_ptxas: str, rglru_ptxas: str) -> dict:
    """8b: RecurrentGemma-9B at full width served through ServingEngine;
    the first K4 and K5 launches of the prefill recorded and held against
    their plain versions; one score pass, its K5 launches counted and the
    first held against the plain version.  8c: K4 and K5 timed at the
    prefill shapes beside their plain versions, their bounds and (K4) the
    SDPA call; K5 also at the score shape, through both routes."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru import plan as RP
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.serve import ServingEngine

    RK_RING, RK_SIMPLE = RK.ROUTE_KEYS[RP.RING], RK.ROUTE_KEYS[RP.SIMPLE]
    cfg = get_arch(LM_ARCH).config
    n_attn = cfg.num_units * sum(s.mixer == "attn" for s in cfg.pattern)
    n_rglru = (cfg.num_units * sum(s.mixer == "rglru" for s in cfg.pattern)
               + sum(s.mixer == "rglru" for s in cfg.tail))
    params, n_params, p_bytes, init_s = lm_params(cfg, device)
    log(f"[8b] {cfg.name}: {n_params / 1e9:.3f} B parameters, "
        f"{p_bytes / 1e9:.2f} GB on the card, initialised from seed {LM_SEED}"
        f" in {init_s:.1f} s ({n_attn} attention + {n_rglru} RG-LRU layers)")

    # -- the main path: counts reset just before, read just after -------
    rec_k5 = Recorder(rglru_ops, "rglru_scan_kernel")
    try:
        wave = serve_wave(cfg, params, device)
    finally:
        rec_k5.restore()
    launches = wave["launches"]
    if launches != {FK.TC: n_attn, FK.F32: 0, RK.TOTAL: n_rglru,
                    RK_RING: n_rglru, RK_SIMPLE: 0}:
        raise AssertionError(f"one prefill launched {launches}, expected "
                             f"{n_attn} tensor-core flash-attention and "
                             f"{n_rglru} RG-LRU scans, all on the ring")
    log_wave("8b", wave)

    # -- the first launches of the prefill, against their plain versions
    with torch.inference_mode():
        q, k, v = wave["k4_args"]
        kw = wave["k4_kwargs"]
        k4_out = FK.flash_attention_bhsd(q, k, v, **kw)
        k4_plain = attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        k4_err = float((k4_out.float() - k4_plain.float()).abs().max())
        k4_rel = flash_err(k4_out, k4_plain)
        del k4_plain
        if k4_rel > FLASH_TOL[str(q.dtype)]:
            raise AssertionError(f"flash kernel on the prefill's inputs: "
                                 f"{k4_rel:.2e} > {FLASH_TOL[str(q.dtype)]}")
        a, bb = rec_k5.args
        k5_out = RK.rglru_scan_kernel(a, bb)
        if not torch.equal(k5_out, rglru_scan_ref(a, bb)):
            raise AssertionError("RG-LRU kernel != plain on the prefill's "
                                 "inputs")
    log(f"[8b] first prefill launches held against their plain versions: "
        f"K4 q {tuple(q.shape)} {q.dtype} k/v {tuple(k.shape)} {kw}: max abs"
        f" {k4_err:.3e} ({k4_rel:.2e} relative, bar "
        f"{FLASH_TOL[str(q.dtype)]}); K5 a/b {tuple(a.shape)} {a.dtype}: "
        "bit-equal")

    # -- scoring: full logits at B = 1 ---------------------------------
    score_toks = np.random.default_rng(LM_SEED + 1).integers(
        0, cfg.vocab_size, LM_SCORE).astype(np.int32)
    rec_score = Recorder(rglru_ops, "rglru_scan_kernel")
    try:
        torch.cuda.synchronize()
        RK.reset_launches()
        t0 = time.perf_counter()
        lp = ServingEngine(cfg, params, max_seq=LM_MAX_SEQ).score(score_toks)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        score_launches = dict(RK.LAUNCHES)
    finally:
        rec_score.restore()
    if score_launches != {RK.TOTAL: n_rglru, RK_RING: n_rglru, RK_SIMPLE: 0}:
        raise AssertionError(f"score launched {score_launches} RG-LRU scans, "
                             f"expected {n_rglru}, all on the ring")
    sa, sb = rec_score.args
    if not torch.equal(RK.rglru_scan_kernel(sa, sb), rglru_scan_ref(sa, sb)):
        raise AssertionError("RG-LRU kernel != plain on score's inputs")
    if not (lp.shape == (LM_SCORE[0], LM_SCORE[1] - 1)
            and np.all(np.isfinite(lp)) and np.all(lp <= 0.0)):
        raise AssertionError("score returned malformed log-probs")
    log(f"[8b] score at B={LM_SCORE[0]} S={LM_SCORE[1]}: {score_s:.2f} s, "
        f"mean log-prob {float(lp.mean()):.2f}; RG-LRU launches "
        f"{score_launches}, the first bit-equal to plain on its inputs "
        f"{tuple(sa.shape)} {sa.dtype}")
    del params
    torch.cuda.empty_cache()

    # -- 8c: times at the prefill shapes --------------------------------
    with torch.inference_mode():
        k4t = time_k4(q, k, v, kw, k4_out)
        (k4_ms, k4_plain_ms, k4_f32_ms, sdpa_ms, pairs, k4_bytes, k4_ops,
         k4_b, k4_by, k4_computed, f32_computed) = (k4t[x] for x in (
             "ms", "plain_ms", "f32_route_ms", "library_ms", "pairs",
             "bytes", "ops", "bound_ms", "bound_by", "computed_flops",
             "f32_computed_flops"))
        bq, hq, sq, d = q.shape
        tc_bq, tc_bk = FK.tile(FK.TC, d)
        f32_bq, f32_bk = FK.tile(FK.F32, d)
        k5 = {"prefill": time_rglru(a, bb), "score": time_rglru(sa, sb)}
        k5_plain_ms = cuda_ms(lambda: rglru_scan_ref(a, bb), warmup=False)
    res = {name: kernel_resources(flash_ptxas, pattern)
           for name, pattern in ((FK.TC, f"flash_fwd_tcILi{d}E"),
                                 (FK.F32, f"flash_fwd_f32ILi{d}E"))}
    log(f"[8c] K4 flash attention at {tuple(q.shape)} {q.dtype}, window "
        f"{kw.get('window')}: tensor-core kernel {k4_ms:.3f} ms "
        f"({k4_computed:.4e} flops computed on {tc_bq}x{tc_bk} tiles: "
        f"{k4_computed / k4_ms / 1e9:.1f} TFLOP/s; "
        f"{k4_ops / k4_ms / 1e9:.1f} TFLOP/s on the {k4_ops:.4e} needed, "
        f"{100 * k4_b / k4_ms:.1f} % of the bound), plain "
        f"{k4_plain_ms:.3f} ms, SDPA "
        f"{sdpa_ms if sdpa_ms is None else round(sdpa_ms, 3)} ms, bound "
        f"{k4_b:.3f} ms ({k4_by}: {pairs} valid pairs per head, "
        f"{k4_bytes / 1e6:.1f} MB)")
    log(f"[8c] K4 CUDA-core route on f32 copies of the same inputs: "
        f"{k4_f32_ms:.3f} ms ({f32_computed:.4e} flops computed on "
        f"{f32_bq}x{f32_bk} tiles: {f32_computed / k4_f32_ms / 1e9:.1f} "
        f"TFLOP/s)")
    for name, (regs, spill) in res.items():
        log(f"[8c] {name} at D={d}: ptxas {regs} registers, {spill}; "
            f"{FK.smem_bytes(name, d)} bytes of dynamic shared memory a "
            f"block")
    for shape, t in k5.items():
        def share(ms):
            return f"{100 * t['bound_ms'] / ms:.1f} %"
        log(f"[8c] K5 RG-LRU scan at the {shape} shape {t['shape']} "
            f"{t['dtype']}, inputs rotated over {t['copies']} copies: one "
            f"call between CUDA events (device time of one of {K5_QUEUED} "
            f"launches queued beside): ring {t['ring_ms']:.4f} ms "
            f"({t['ring_queued_ms']:.4f}), {share(t['ring_ms'])} of the bound "
            f"({share(t['ring_queued_ms'])}); simple route "
            f"{t['simple_ms']:.4f} ms ({t['simple_queued_ms']:.4f}), "
            f"{share(t['simple_ms'])} of the bound "
            f"({share(t['simple_queued_ms'])}); bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes'] / 1e6:.1f} MB); "
            f"torch.add(a, b, out=h), the same bytes but not the same "
            f"function, {t['add_ms']:.4f} ms ({t['add_queued_ms']:.4f}); "
            f"plan {t['plan']}")
    regs, spill = kernel_resources(rglru_ptxas, ring_kernel_name(
        a.dtype, k5["prefill"]["plan"]))
    log(f"[8c] K5 ring kernel at the prefill shape: ptxas {regs} registers, "
        f"{spill}; {k5['prefill']['plan'].smem_bytes} bytes of dynamic "
        f"shared memory a block; plain version {k5_plain_ms:.3f} ms")
    return {
        "k4": {"launches": launches[FK.TC], "max_abs_err": k4_err,
               "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_b,
               "bound_by": k4_by, "library_ms": sdpa_ms},
        "k5": {"launches": launches[RK.TOTAL], "max_abs_err": 0.0,
               "ms": k5["prefill"]["ring_ms"], "plain_ms": k5_plain_ms,
               "bound_ms": k5["prefill"]["bound_ms"],
               "bound_by": k5["prefill"]["bound_by"], "library_ms": None,
               "queued_ms": k5["prefill"]["ring_queued_ms"],
               "routes": {
                   route: {"launches": launches[RK.ROUTE_KEYS[route]],
                           "score_launches":
                               score_launches[RK.ROUTE_KEYS[route]],
                           **{f"{shape}_{k}": t[f"{route}_{k}"]
                              for shape, t in k5.items()
                              for k in ("ms", "queued_ms")}}
                   for route in (RP.RING, RP.SIMPLE)},
               "ring_registers": regs,
               "ring_dynamic_smem": k5["prefill"]["plan"].smem_bytes,
               "same_bytes_torch_add_ms": {
                   f"{shape}_{k}": t[f"add_{k}"] for shape, t in k5.items()
                   for k in ("ms", "queued_ms")},
               "score_shape_bound_ms": k5["score"]["bound_ms"]},
        "n_params": n_params, "param_gb": p_bytes / 1e9, "init_s": init_s,
        **{k: wave[k] for k in ("generate_s", "prefill_s", "decode_s",
                                "decode_tokens_per_s", "peak_device_gb",
                                "prefill_memory")},
        "score_s": score_s,
        "k4_rel_err": k4_rel, "k4_valid_pairs_per_head": pairs,
        "k4_computed_flops": k4_computed, "k4_f32_route_ms": k4_f32_ms,
    }


# ---------------------------------------------------------------------------
# phase 9: request-level workloads — scheduling, faults and hedges through
# the port's Simulator, K1 pricing the fault-extended arrival traces
# ---------------------------------------------------------------------------


def offered_stream(sim, n_requests: int, pages: int, seed: int):
    """``poisson_stream`` offered at OFFERED_LOAD of the drive's own rate
    for its mix, and that rate (ops/us): the stream lowered with zero
    arrivals by the static stripe scheduler on ``engine="cuda"``, ops over
    ``end_us``, as phase 6 sets its arrivals.  numpy draws the gaps as
    standard exponentials times the mean, so the probe's classes are the
    stream's whatever the mean (checked)."""
    import dataclasses

    import numpy as np
    from repro_torch.core.workload import poisson_stream

    def build(gap):
        return poisson_stream(n_requests, gap, read_fraction=WL_READ_FRACTION,
                              pages_per_request=pages, seed=seed)
    probe = build(1.0)
    burst = sim.run(dataclasses.replace(
        probe, arrival_us=np.zeros(n_requests, np.float32)), engine="cuda")
    rate = burst.n_ops / burst.end_us
    stream = build(pages / (OFFERED_LOAD * rate))
    if not np.array_equal(stream.op_cls, probe.op_cls):
        raise AssertionError("the offered stream's mix differs from the "
                             "probe's")
    return stream, rate


def percentiles(res) -> dict:
    return {q: getattr(res, q) for q in ("p50_us", "p99_us", "p99_9_us")}


def phase_workloads(device) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.api import (DYNAMIC_POLICIES, FaultSampler, FaultSpec,
                                 Simulator)
    from repro_torch.core import sched, workload
    from repro_torch.core import sim as core_sim
    from repro_torch.core.interface import InterfaceKind
    from repro_torch.core.maxplus_form import StateLayout, end_time_from_state
    from repro_torch.core.nand import CellType
    from repro_torch.core.sim import SSDConfig
    from repro_torch.core.trace import READ
    from repro_torch.kernels.maxplus import kernel as K
    from repro_torch.kernels.maxplus import ops as maxplus_ops
    from repro_torch.kernels.maxplus.ref import maxplus_fold_ref

    t_phase = time.perf_counter()
    cfg = SSDConfig(interface=InterfaceKind.PROPOSED, cell=CellType.SLC,
                    channels=WL_CHANNELS, ways=WL_WAYS)
    sim = Simulator(cfg, device=device)
    cpu = Simulator(cfg, device="cpu")
    layout = StateLayout(WL_CHANNELS, WL_WAYS)

    # -- 9a: static stripe, faults and hedges ---------------------------
    stream, rate = offered_stream(sim, WL_REQUESTS, WL_PAGES, WL_SEED)
    spec = FaultSpec(**WL_STATIC_FAULTS)
    # the host's share, each step timed apart as the query runs it
    t0 = time.perf_counter()
    hedged = workload.with_hedges(stream, spec.hedge_fraction,
                                  after_us=spec.hedge_after_us or 0.0,
                                  seed=spec.seed)
    t1 = time.perf_counter()
    low = sched.lower_static(hedged, WL_CHANNELS, WL_WAYS)
    t2 = time.perf_counter()
    faulty, _, sampler = sched.apply_faults(low.trace, spec, sim.table,
                                            request_id=low.request_id)
    t3 = time.perf_counter()
    host = {"hedge_s": t1 - t0, "lower_s": t2 - t1, "faults_s": t3 - t2}
    n_reads = int(np.sum(low.trace.cls == READ))
    log(f"[9a] {cfg.describe()}: poisson_stream({WL_REQUESTS}, "
        f"{float(stream.arrival_us[-1]) / (WL_REQUESTS - 1):.4f} us mean "
        f"gap, read_fraction={WL_READ_FRACTION}, pages_per_request="
        f"{WL_PAGES}) offered at {OFFERED_LOAD} of the drive's "
        f"{rate:.4f} ops/us for the mix; {hedged.n_requests - WL_REQUESTS} "
        f"hedges, {faulty.n_ops} ops after {sampler.n_remap_ops} remaps; "
        f"host: hedging {host['hedge_s']:.3f} s, stripe lowering "
        f"{host['lower_s']:.3f} s, fault sampling {host['faults_s']:.3f} s")

    # the main path: counts reset just before, read just after
    torch.cuda.synchronize()
    rec = Recorder(maxplus_ops, "maxplus_fold_kernel")
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        res_cuda = sim.run(stream, faults=spec, objective="all",
                           engine="cuda")
        torch.cuda.synchronize()
        cuda_wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        rec.restore()
    if not (launches["indexed"] >= 1
            and launches["indexed/compact"] == launches["indexed"]
            and launches["periodic"] == launches["many"] == 0):
        raise AssertionError(f"the workload query on cuda launched "
                             f"{launches}: K1 on the compact route expected")
    mats, s0 = rec.args
    kw = rec.kwargs
    k1_out = K.maxplus_fold_kernel(mats, s0, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k1_plain = maxplus_fold_ref(mats, s0, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(k1_out, k1_plain):
        raise AssertionError(
            f"K1 != plain on the workload query's inputs (max abs "
            f"{float((k1_out - k1_plain).abs().max())})")
    k1_end = float(end_time_from_state(k1_out.cpu().numpy(), layout)[0])
    if k1_end != res_cuda.end_us or res_cuda.request_lat_us is not None:
        raise AssertionError(f"cuda query end {res_cuda.end_us} != its "
                             f"first K1 launch's {k1_end}")
    k1 = time_fold(mats, s0, kw, dense=False)
    del k1_plain, k1["out"]

    if not (res_cuda.n_ops == faulty.n_ops
            and res_cuda.n_remap_ops == sampler.n_remap_ops > 0
            and int(res_cuda.retry_hist.sum()) == n_reads
            and np.array_equal(res_cuda.retry_hist, sampler.retry_hist)):
        raise AssertionError(f"[cuda] {res_cuda.n_ops} ops, n_remap_ops "
                             f"{res_cuda.n_remap_ops}, retry_hist "
                             f"{res_cuda.retry_hist} over {n_reads} reads")
    # scan, cuda and the oracle on the stream's first WL_SCAN_REQUESTS
    cut = dataclasses.replace(stream, **{
        f: getattr(stream, f)[:WL_SCAN_REQUESTS]
        for f in ("arrival_us", "op_cls", "n_pages", "stream")})
    res_cut = sim.run(cut, faults=spec, objective="all", engine="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_scan = sim.run(cut, faults=spec, objective="all", engine="scan")
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t0
    n_ops = res_scan.n_ops
    drift = rel(res_scan.end_us, res_cut.end_us)
    e_err = max(rel(getattr(res_scan.energy, f), getattr(res_cut.energy, f))
                for f in ENERGY_FIELDS)
    if not (n_ops == res_cut.n_ops
            and drift <= n_ops * F32_DRIFT_PER_OP and e_err <= ENERGY_TOL):
        raise AssertionError(f"scan vs cuda on the workload: {n_ops} / "
                             f"{res_cut.n_ops} ops, end {drift:.2e} (bar "
                             f"{n_ops * F32_DRIFT_PER_OP:.2e}), energy "
                             f"{e_err:.2e}")
    if not (res_scan.n_remap_ops == res_cut.n_remap_ops > 0
            and np.array_equal(res_scan.retry_hist, res_cut.retry_hist)):
        raise AssertionError(f"[scan] n_remap_ops {res_scan.n_remap_ops}, "
                             f"retry_hist {res_scan.retry_hist} against "
                             f"cuda's {res_cut.retry_hist}")
    lat = res_scan.request_lat_us
    if not (len(lat) == WL_SCAN_REQUESTS and np.all(np.isfinite(lat))
            and np.all(lat > 0)):
        raise AssertionError("scan's request latencies malformed")
    t0 = time.perf_counter()
    res_oracle = sim.run(cut, faults=spec, engine="oracle")
    oracle_wall = time.perf_counter() - t0
    pct, pct_oracle = percentiles(res_scan), percentiles(res_oracle)
    pct_err = max(rel(pct[q], pct_oracle[q]) for q in pct)
    if pct_err > PERCENTILE_TOL:
        raise AssertionError(f"scan vs oracle percentiles: {pct} vs "
                             f"{pct_oracle}")
    prefix = dataclasses.replace(stream, **{
        f: getattr(stream, f)[:WL_PREFIX]
        for f in ("arrival_us", "op_cls", "n_pages", "stream")})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre_card = sim.run(prefix, faults=spec)
    torch.cuda.synchronize()
    prefix_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre_cpu = cpu.run(prefix, faults=spec)
    prefix_cpu_wall = time.perf_counter() - t0
    if not (pre_card.end_us == pre_cpu.end_us and np.array_equal(
            pre_card.request_lat_us, pre_cpu.request_lat_us)):
        raise AssertionError(f"scan on the card != the CPU on the "
                             f"{WL_PREFIX}-request prefix")
    log(f"[9a] Simulator.run(stream, faults, objective='all'): cuda "
        f"{cuda_wall:.2f} s wall ({res_cuda.n_ops / cuda_wall:.0f} ops/s; K1 "
        f"{launches['indexed']} launches, all on the compact route); on its "
        f"first {WL_SCAN_REQUESTS} requests ({n_ops} ops) scan "
        f"{scan_wall:.1f} s ({n_ops / scan_wall:.0f} ops/s: the completions "
        f"and the energy folds), oracle {oracle_wall:.1f} s; scan vs cuda "
        f"end {drift:.2e} (< T*2^-24 = {n_ops * F32_DRIFT_PER_OP:.2e}), "
        f"energy {e_err:.2e} (< {ENERGY_TOL}); scan vs oracle percentiles "
        f"{pct_err:.2e} (< {PERCENTILE_TOL}); {res_scan.describe()}")
    log(f"[9a] p50 / p99 / p99.9 {pct['p50_us']:.2f} / {pct['p99_us']:.2f}"
        f" / {pct['p99_9_us']:.2f} us (scan, first {WL_SCAN_REQUESTS} "
        f"requests); the whole query's retry_hist "
        f"{res_cuda.retry_hist.tolist()} over {n_reads} reads, n_remap_ops "
        f"{res_cuda.n_remap_ops}; {WL_PREFIX}-request prefix "
        f"({pre_card.n_ops} ops): card {prefix_wall:.2f} s, CPU "
        f"{prefix_cpu_wall:.2f} s, latencies bit-equal")
    log(f"[9a] first K1 launch of the query (B={mats.shape[0]} "
        f"M={mats.shape[1]} N={mats.shape[2]} T={kw['t_steps']}, arrivals "
        f"and surcharges) bit-equal to maxplus_fold_ref on the card (plain "
        f"{plain_s:.1f} s), its end time the query's: compact route "
        f"{k1['ms']:.3f} ms (pre-pass {k1['prepass_ms']:.3f} ms, fold alone "
        f"{k1['fold_ms']:.3f} ms, {k1['ns_per_step']:.1f} ns a step; host "
        f"wall of one call {k1['host_ms']:.3f} ms); bound "
        f"{k1['bound_ms']:.4f} ms "
        f"({k1['bound_by']}; the dense count "
        f"{k1['bound_ms_dense_count']:.4f} ms)")

    # -- 9b: dynamic dispatch with retired ways -------------------------
    stream_b, rate_b = offered_stream(sim, WL_DYN_REQUESTS, WL_DYN_PAGES,
                                      WL_DYN_SEED)
    spec_b = FaultSpec(**WL_DYN_FAULTS)
    t0 = time.perf_counter()
    cls, _, _, _ = workload.request_ops(stream_b)
    t1 = time.perf_counter()
    smp = FaultSampler(spec_b, WL_CHANNELS, WL_WAYS, sim.table)
    smp.sample(cls)
    host_b = {"expand_s": t1 - t0, "faults_s": time.perf_counter() - t1}
    if not smp.retired.any():
        raise AssertionError("9b's fault spec retired no way")
    captured = []
    real = core_sim.dispatch_trace

    def capture(*a, **k):
        out = real(*a, **k)
        captured.append(out)
        return out
    dyn = {}
    core_sim.dispatch_trace = capture
    try:
        for rule in DYNAMIC_POLICIES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = sim.run(stream_b, sched_policy=rule, faults=spec_b,
                           objective="all")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            host_res = cpu.run(stream_b, sched_policy=rule, faults=spec_b,
                               objective="all")
            dyn[rule] = {"card": card, "cpu": host_res, "wall_s": wall,
                         "cpu_wall_s": time.perf_counter() - t0}
    finally:
        core_sim.dispatch_trace = real
    if len(captured) != 2 * len(DYNAMIC_POLICIES):
        raise AssertionError(f"{len(captured)} dispatch folds recorded")
    for i, rule in enumerate(DYNAMIC_POLICIES):
        on_card, on_cpu = captured[2 * i], captured[2 * i + 1]
        if (on_card[1].device.type != sim.device.type
                or on_cpu[1].device.type != "cpu"):
            raise AssertionError(f"{rule}: the dispatch folds ran on "
                                 f"{on_card[1].device} / {on_cpu[1].device}")
        for name, a, b in zip(("end", "completions", "channels", "ways",
                               "parities"), on_card, on_cpu):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{rule}: {name} on the card != CPU")
        chan, way = on_cpu[2].numpy(), on_cpu[3].numpy()
        if smp.retired[chan, way].any():
            raise AssertionError(f"{rule} placed an op on a retired way")
        r, h = dyn[rule]["card"], dyn[rule]["cpu"]
        if not (r.end_us == h.end_us and np.array_equal(
                r.request_lat_us, h.request_lat_us)
                and r.energy.total_j == h.energy.total_j
                and r.n_remap_ops == h.n_remap_ops > 0
                and np.array_equal(r.retry_hist, h.retry_hist)):
            raise AssertionError(f"{rule}: the card's result != the CPU's")
        dyn[rule]["n_ops"] = r.n_ops
        dyn[rule]["pct"] = percentiles(r)
        log(f"[9b] {rule}: {r.n_ops} ops on the card in "
            f"{dyn[rule]['wall_s']:.2f} s ({r.n_ops / dyn[rule]['wall_s']:.0f}"
            f" ops/s), on the CPU {dyn[rule]['cpu_wall_s']:.2f} s; "
            f"placements, parities, completions and latencies bit-equal, "
            f"no op on the {int(smp.retired.sum())} retired ways; p50 / p99 "
            f"/ p99.9 {r.p50_us:.2f} / {r.p99_us:.2f} / {r.p99_9_us:.2f} us; "
            f"retry_hist {r.retry_hist.tolist()}; n_remap_ops "
            f"{r.n_remap_ops}; {r.describe()}")
    # the rules against each other: where every chosen chip is idle when
    # its channel's bus frees, the way does not move a completion
    (_, c_ll, ch_ll, w_ll, _), (_, c_er, ch_er, w_er, _) = (
        captured[2 * i + 1] for i in range(2))
    rules_apart = {"channel": int((ch_ll != ch_er).sum()),
                   "way": int((w_ll != w_er).sum()),
                   "completion": int((c_ll != c_er).sum())}
    log(f"[9b] least_loaded vs earliest_ready: of {len(c_ll)} ops, "
        f"{rules_apart['channel']} on another channel, {rules_apart['way']} "
        f"on another way, {rules_apart['completion']} with another "
        f"completion")
    log(f"[9b] poisson_stream({WL_DYN_REQUESTS}, pages_per_request="
        f"{WL_DYN_PAGES}) offered at {OFFERED_LOAD} of {rate_b:.4f} ops/us; "
        f"host: request expansion {host_b['expand_s']:.3f} s, fault "
        f"sampling {host_b['faults_s']:.3f} s")
    seconds = time.perf_counter() - t_phase
    log(f"[9] request-level workloads in {seconds:.1f} s")
    return {"launches": launches,
            "query": (stream, spec, res_cuda, faulty),
            "k1": k1, "seconds": seconds,
            "rate_ops_per_us": rate, "n_ops": res_cuda.n_ops,
            "scan_requests": WL_SCAN_REQUESTS, "scan_n_ops": n_ops,
            "host": host,
            "cuda_wall_s": cuda_wall, "scan_wall_s": scan_wall,
            "oracle_wall_s": oracle_wall, "plain_s": plain_s,
            "scan_ops_per_s": n_ops / scan_wall,
            "percentiles": pct, "percentiles_oracle": pct_oracle,
            "retry_hist": res_cuda.retry_hist.tolist(),
            "n_remap_ops": res_cuda.n_remap_ops,
            "end_us": {"cuda": res_cuda.end_us, "cuda_cut": res_cut.end_us,
                       "scan_cut": res_scan.end_us},
            "prefix_wall_s": [prefix_wall, prefix_cpu_wall],
            "dynamic": {
                rule: {"wall_s": d["wall_s"], "cpu_wall_s": d["cpu_wall_s"],
                       "n_ops": d["n_ops"], "percentiles": d["pct"],
                       "ops_per_s": d["n_ops"] / d["wall_s"],
                       "retry_hist": d["card"].retry_hist.tolist(),
                       "n_remap_ops": d["card"].n_remap_ops}
                for rule, d in dyn.items()},
            "dynamic_rate_ops_per_us": rate_b, "dynamic_host": host_b,
            "rules_apart": rules_apart,
            "retired_ways": int(smp.retired.sum())}


# ---------------------------------------------------------------------------
# phase 10: the log-depth engines (prefix, squaring) on the card
# ---------------------------------------------------------------------------


class DeviceLog:
    """Wraps ``maxplus_form.structured_segment_products``, the fold every
    ``prefix`` and ``squaring`` query runs, and records the device of
    each product block it returns."""

    def __init__(self):
        from repro_torch.core import maxplus_form as mf
        self.mf, self.fn = mf, mf.structured_segment_products
        self.devices = []
        mf.structured_segment_products = self

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.devices.append(out.device.type)
        return out

    def on_card(self, label, fn):
        """``fn()``, required to have run its folds on the card."""
        n = len(self.devices)
        out = fn()
        ran = self.devices[n:]
        if not ran or any(d != "cuda" for d in ran):
            raise AssertionError(f"{label}: folds ran on {ran}, not the card")
        return out

    def restore(self):
        self.mf.structured_segment_products = self.fn


def profiled(fn, cpu: bool = True) -> dict:
    """Device time and count of the CUDA kernels one call of ``fn`` runs,
    and their device time (ms) by kernel name (template arguments and
    parameters cut), by ``torch.profiler`` (tracing the CPU's ops too
    where ``cpu``); "not measured" where it records no device event."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_ms": "not measured", "kernels": "not measured",
                "by_name": "not measured"}
    by_name = {}
    for e in kernels:
        # "void (anonymous namespace)::tcb::flash_bwd_dq_tc<64>(...)"
        m = re.search(r"(\w+)(?:<[^()]*>)?\(",
                      e.name.replace("(anonymous namespace)", ""))
        name = m[1] if m else e.name
        by_name[name] = (by_name.get(name, 0.0)
                         + e.time_range.elapsed_us() / 1e3)
    return {"device_ms": sum(by_name.values()), "kernels": len(kernels),
            "by_name": by_name}


def timed(fn) -> tuple[float, object]:
    """(synchronised wall seconds of one call of ``fn``, its result)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_logdepth(device, trace, tables, cuda_ends, cuda_sweep_s,
                   cuda_setup_s, query) -> dict:
    import numpy as np
    import torch
    from repro_torch.api import (Simulator, steady_bandwidth_mb_s,
                                 sweep_steady_bandwidth_mb_s, sweep_tables)
    from repro_torch.core import calibrate
    from repro_torch.core.api import _table_tensors
    from repro_torch.core.interface import InterfaceKind, make_interface
    from repro_torch.core.nand import CellType
    from repro_torch.core.nand import chip as nand_chip
    from repro_torch.core.paper_tables import INTERFACE_ORDER, TABLE3
    from repro_torch.core.sim import SSDConfig, page_op_params
    from repro_torch.core.trace import READ, WRITE, steady_trace
    from repro_torch.kernels.maxplus import kernel as K
    from repro_torch.kernels.maxplus import ops as maxplus_ops
    from repro_torch.kernels.maxplus.ref import maxplus_fold_ref
    from repro_torch.tables import cell_config

    t_phase = time.perf_counter()
    launches_before = dict(K.LAUNCHES)
    log_ = DeviceLog()
    try:
        # -- 10a: the 64-point sweep on prefix ---------------------------
        bar = trace.n_ops * F32_DRIFT_PER_OP
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ends = log_.on_card("prefix sweep",
                            lambda: sweep_tables(tables, trace))
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        chain_s = wall_ms(lambda: sweep_tables(tables, trace)) / 1e3
        stage_s = wall_ms(lambda: (_table_tensors(tables, device), [
            torch.as_tensor(np.asarray(x), device=device) for x in (
                trace.cls, trace.channel, trace.way, trace.parity)])) / 1e3
        prof = profiled(lambda: sweep_tables(tables, trace))
        drift = float(np.max(np.abs(ends - cuda_ends) / cuda_ends))
        if not (ends.shape == cuda_ends.shape and drift <= bar):
            raise AssertionError(f"prefix sweep vs cuda: {drift:.2e} (bar "
                                 f"{bar:.2e})")
        pts = list(PREFIX_CPU_POINTS)
        t0 = time.perf_counter()
        cpu_ends = sweep_tables([tables[j] for j in pts], trace,
                                device="cpu")
        cpu_s = time.perf_counter() - t0
        if not np.array_equal(cpu_ends, ends[pts]):
            raise AssertionError(f"prefix sweep on the card != the CPU on "
                                 f"points {pts}: {ends[pts]} vs {cpu_ends}")
        apts = list(PREFIX_ASSOC_POINTS)
        sub = [tables[j] for j in apts]
        assoc_s, assoc = timed(lambda: log_.on_card(
            "assoc sweep", lambda: sweep_tables(sub, trace,
                                                combine="assoc")))
        t0 = time.perf_counter()
        assoc_cpu = sweep_tables(sub, trace, combine="assoc", device="cpu")
        assoc_cpu_s = time.perf_counter() - t0
        assoc_drift = float(np.max(np.abs(assoc - cuda_ends[apts])
                                   / cuda_ends[apts]))
        if not (np.array_equal(assoc, assoc_cpu) and assoc_drift <= bar):
            raise AssertionError(f"assoc sweep: card {assoc}, CPU "
                                 f"{assoc_cpu}, vs cuda {assoc_drift:.2e}")
        log(f"[10a] sweep_tables(engine='prefix') (the default; chain, "
            f"segment_len 64: S = {-(-trace.n_ops // 64)}) on phase 5's "
            f"{len(tables)} points: {chain_s:.3f} s wall (median of 3; "
            f"staging tables and trace on the card {stage_s * 1e3:.1f} ms; "
            f"profiler: {prof['kernels']} kernels, {prof['device_ms']} ms "
            f"on the device) against cuda's {cuda_sweep_s:.2f} s (host "
            f"dictionary {cuda_setup_s:.2f} s); peak device memory "
            f"{peak_gb:.2f} GB; vs cuda {drift:.2e} (< T*2^-24 = "
            f"{bar:.2e}); points {pts} bit-equal to the CPU ({cpu_s:.1f} "
            f"s there); combine='assoc' on points {apts}: {assoc_s:.3f} s, "
            f"bit-equal to the CPU ({assoc_cpu_s:.1f} s), vs cuda "
            f"{assoc_drift:.2e}")

        # -- 10b: squaring on homogeneous streams ------------------------
        cells = [(c, k, w) for c in ("slc", "mlc") for k in INTERFACE_ORDER
                 for w in (1, 2, 4, 8, 16)]
        ops = [page_op_params(make_interface(InterfaceKind(k)),
                              nand_chip(CellType(c)), "write", w)
               for c, k, w in cells]
        cols = [np.asarray([float(getattr(op, f)) for op in ops])
                for f in calibrate._OP_FIELDS]
        ways = np.asarray([w for *_, w in cells], np.int32)
        sq = log_.on_card("squaring sweep", lambda: (
            sweep_steady_bandwidth_mb_s(*cols, ways, engine="squaring")))
        sq_s = wall_ms(lambda: sweep_steady_bandwidth_mb_s(
            *cols, ways, engine="squaring")) / 1e3
        scan_bw = sweep_steady_bandwidth_mb_s(*cols, ways)
        sq_cpu = sweep_steady_bandwidth_mb_s(*cols, ways, engine="squaring",
                                             device="cpu")
        sq_drift = float(np.max(np.abs(sq / scan_bw - 1.0)))
        if not (np.array_equal(sq, sq_cpu)
                and sq_drift <= 512 * F32_DRIFT_PER_OP):
            raise AssertionError(f"squaring sweep: card vs CPU equal "
                                 f"{np.array_equal(sq, sq_cpu)}, vs scan "
                                 f"{sq_drift:.2e}")
        t0 = time.perf_counter()
        errs, worst_engines, n_cells = [], 0.0, 0
        for cell, by_mode in TABLE3.items():
            for mode, by_ways in by_mode.items():
                for w, row in by_ways.items():
                    for kind, paper in zip(INTERFACE_ORDER, row):
                        cfg = cell_config(cell, w, kind)
                        tr = steady_trace(512, 1, w,
                                          READ if mode == "read" else WRITE)
                        res = log_.on_card("squaring run", lambda: Simulator(
                            cfg, device=device).run(
                                tr, engine="squaring", objective="all"))
                        bw = min(res.mb_s, cfg.sata_mb_s)
                        scan = steady_bandwidth_mb_s(cfg, mode)
                        worst_engines = max(worst_engines, rel(bw, scan))
                        if not (res.energy.total_j > 0
                                and np.isfinite(res.energy.nj_per_byte)):
                            raise AssertionError(f"{cfg.describe()} "
                                                 f"{mode}: energy malformed")
                        n_cells += 1
                        if (cell, mode, w, kind) not in ANOMALIES:
                            errs.append(rel(bw, paper))
        table_s = time.perf_counter() - t0
        mean3, worst3 = float(np.mean(errs)), float(max(errs))
        if not (mean3 < T3_MEAN_TOL and worst3 < T3_WORST_TOL
                and worst_engines <= 512 * F32_DRIFT_PER_OP):
            raise AssertionError(f"Table 3 on squaring: mean {mean3:.4f}, "
                                 f"worst {worst3:.4f}, vs scan "
                                 f"{worst_engines:.2e}")
        log(f"[10b] sweep_steady_bandwidth_mb_s(engine='squaring') on "
            f"{len(cells)} Table 3/4 write points (ways 1-16, n_pages 512): "
            f"{sq_s * 1e3:.1f} ms, bit-equal to the CPU, vs scan "
            f"{sq_drift:.2e} (< {512 * F32_DRIFT_PER_OP:.2e}); "
            f"Simulator.run(steady_trace, engine='squaring', objective="
            f"'all') on the {n_cells} Table 3 cells in {table_s:.1f} s "
            f"(scan beside): vs scan {worst_engines:.2e}, paper mean rel "
            f"err {mean3:.4f} (< {T3_MEAN_TOL}), worst {worst3:.4f} (< "
            f"{T3_WORST_TOL})")

        # -- 10c: phase 9a's workload query on prefix --------------------
        stream, spec, res_cuda, faulty = query
        sim = Simulator(SSDConfig(interface=InterfaceKind.PROPOSED,
                                  cell=CellType.SLC, channels=WL_CHANNELS,
                                  ways=WL_WAYS), device=device)
        wl_s, res = timed(lambda: log_.on_card(
            "prefix workload", lambda: sim.run(
                stream, faults=spec, engine="prefix", objective="all")))
        n_ops = res.n_ops
        wl_drift = rel(res.end_us, res_cuda.end_us)
        # energy: cuda's kernel (like scan) sums its T per-op energies one
        # float32 add at a time, which drifts by up to T * 2^-24; prefix
        # sums segments of 64, then the segment sums.  Both are held to
        # that drift apart, and prefix to the float64 per-op sum of the
        # same trace within ENERGY_TOL
        exact = sim._breakdown(sim._linear_energy_sums(faulty, sim.kind),
                               res.end_us, faulty)
        wl_e = max(rel(getattr(res.energy, f), getattr(res_cuda.energy, f))
                   for f in ENERGY_FIELDS)
        wl_e64 = max(rel(getattr(res.energy, f), getattr(exact, f))
                     for f in ENERGY_FIELDS)
        cuda_e64 = max(rel(getattr(res_cuda.energy, f), getattr(exact, f))
                       for f in ENERGY_FIELDS)
        if not (n_ops == res_cuda.n_ops == faulty.n_ops
                and res.request_lat_us is None
                and wl_drift <= n_ops * F32_DRIFT_PER_OP
                and wl_e <= n_ops * F32_DRIFT_PER_OP
                and wl_e64 <= ENERGY_TOL
                and res.n_remap_ops == res_cuda.n_remap_ops):
            raise AssertionError(f"prefix workload query: end vs cuda "
                                 f"{wl_drift:.2e}, energy vs cuda "
                                 f"{wl_e:.2e}, vs the float64 sum "
                                 f"{wl_e64:.2e}, {n_ops} / "
                                 f"{res_cuda.n_ops} ops")
        log(f"[10c] Simulator.run(stream, faults, engine='prefix', "
            f"objective='all') on 9a's query ({n_ops} ops, S = "
            f"{-(-n_ops // 64)} segments, two folds): {wl_s:.2f} s "
            f"({n_ops / wl_s:.0f} ops/s); vs cuda end {wl_drift:.2e} "
            f"(< T*2^-24 = {n_ops * F32_DRIFT_PER_OP:.2e}), energy "
            f"{wl_e:.2e} (same bar); energy vs the float64 per-op sum: "
            f"prefix {wl_e64:.2e} (< {ENERGY_TOL}), cuda {cuda_e64:.2e}; "
            f"no latencies (makespan-only engine)")

        # -- 10d: the strategies of ops.maxplus_fold ---------------------
        worst_d = 0.0
        (_, rmats, rs0, t, rin), (_, mats, s0, _, inputs) = \
            small_cases(device)
        idx, arrivals, extras, _, gvec, wvec = inputs
        # arrivals enter through the origin column, which needs the origin
        # row of a maxplus_form dictionary and s0 = 0 there
        s0_origin = s0.clone()
        s0_origin[..., -1] = 0.0
        runs = [(m, s, strategy, kw)
                for m, s, i in ((rmats, rs0, rin[0]), (mats, s0, idx))
                for strategy, kw in (("segmented", {}), ("squaring", {}),
                                     ("segmented", dict(idx=i)))]
        runs.append((mats, s0_origin, "segmented", dict(
            idx=idx, arrivals=arrivals, gvec=gvec, extras=extras,
            wvec=wvec)))
        for m, s, strategy, kw in runs:
            label = f"B={m.shape[0]} M={m.shape[1]} N={m.shape[2]}"
            got = maxplus_ops.maxplus_fold(m, s, t_steps=t,
                                           strategy=strategy, **kw)
            want = maxplus_fold_ref(m, s, t_steps=t, **kw)
            err = float((got - want).abs().max() / want.abs().max())
            if not (got.device.type == "cuda"
                    and err <= t * F32_DRIFT_PER_OP):
                raise AssertionError(f"{label} {strategy} {list(kw)}: "
                                     f"{err:.2e} of the plain fold")
            worst_d = max(worst_d, err)
        log(f"[10d] ops.maxplus_fold(strategy='segmented' periodic and "
            f"indexed, 'squaring' periodic) on phase 3's two dictionaries, "
            f"'segmented' indexed+arrivals+extras on the 4x8 one, on the "
            f"card: within {worst_d:.2e} of K1's plain version (< T*2^-24 "
            f"= {t * F32_DRIFT_PER_OP:.2e})")
    finally:
        log_.restore()
    launched = {k: v - launches_before[k] for k, v in K.LAUNCHES.items()
                if v != launches_before[k]}
    if launched:
        raise AssertionError(f"phase 10 launched (max,+) kernels: {launched}")
    seconds = time.perf_counter() - t_phase
    log(f"[10] log-depth engines in {seconds:.1f} s; no kernel launched")
    return {"prefix_sweep_s": chain_s, "stage_s": stage_s,
            "prefix_sweep_profile": prof, "peak_device_gb": peak_gb,
            "prefix_vs_cuda": drift, "cpu_points_s": cpu_s,
            "assoc_s": assoc_s, "assoc_cpu_s": assoc_cpu_s,
            "assoc_vs_cuda": assoc_drift, "cuda_sweep_s": cuda_sweep_s,
            "squaring_sweep_ms": sq_s * 1e3, "squaring_vs_scan": sq_drift,
            "squaring_table3": {"mean": mean3, "worst": worst3,
                                "vs_scan": worst_engines,
                                "seconds": table_s},
            "workload_s": wl_s, "workload_vs_cuda": wl_drift,
            "workload_energy_vs_cuda": wl_e,
            "workload_energy_vs_float64": {"prefix": wl_e64,
                                           "cuda": cuda_e64},
            "strategies_worst": worst_d,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 11: the FTL (slice E) — translation on the card, GC-translated
# traces priced by K1, aging streams and the aged sweep
# ---------------------------------------------------------------------------


class FoldLog:
    """Wraps the folds of the FTL paths — the translation machine's step
    loop (``_drive``), the scan engine's and the lane-batched masked fold —
    and records the device each call ran on, with the translation's steps
    and seconds."""

    def __init__(self):
        from repro_torch.core import ftl_scan
        from repro_torch.core import sim as core_sim
        self.targets = [(ftl_scan, "_drive", lambda a: a[1].h.device),
                        (core_sim, "_fold", lambda a: a[0][0].device),
                        (core_sim, "_trace_end_time_prefix_impl",
                         lambda a: a[0][0].device),
                        (core_sim, "_trace_end_time_masked_impl",
                         lambda a: a[0].device)]
        self.calls = []      # (name, device type, steps or None, seconds)
        self.real = {}
        for mod, name, dev in self.targets:
            real = getattr(mod, name)
            self.real[(mod, name)] = real
            setattr(mod, name, self._wrap(name, real, dev))

    def _wrap(self, name, real, dev):
        import torch

        def call(*args, **kwargs):
            d = dev(args)
            if name == "_drive" and d.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            if name == "_drive" and d.type == "cuda":
                torch.cuda.synchronize()
            self.calls.append((name, d.type,
                               out[2] if name == "_drive" else None,
                               time.perf_counter() - t0))
            return out
        return call

    def on_card(self, label, fn, folds=("_drive",)):
        """``fn()``, required to have run each of ``folds`` at least once,
        and every fold it ran, on the card."""
        n = len(self.calls)
        out = fn()
        ran = self.calls[n:]
        names = {c[0] for c in ran}
        if (any(c[1] != "cuda" for c in ran)
                or not set(folds) <= names):
            raise AssertionError(f"{label}: folds ran as "
                                 f"{[(c[0], c[1]) for c in ran]}")
        return out, ran

    def restore(self):
        for (mod, name), real in self.real.items():
            setattr(mod, name, real)


def translation_steps(ran) -> tuple[int, float]:
    """(steps, seconds) of the translation-machine runs in ``ran``."""
    drives = [c for c in ran if c[0] == "_drive"]
    return sum(c[2] for c in drives), sum(c[3] for c in drives)


def same_translation(got, want) -> list:
    """The fields in which two translations differ (op stream, stats,
    final drive state)."""
    import numpy as np
    bad = [f for f in ("op_cls", "arrival_us", "payload", "request_id", "gc")
           if not np.array_equal(getattr(got, f), getattr(want, f))]
    if got.stats != want.stats:
        bad.append("stats")
    bad += [f for f in ("l2p", "p2l", "valid_count", "full", "fill_seq",
                        "erase_count")
            if not np.array_equal(getattr(got.state, f),
                                  getattr(want.state, f))]
    if list(got.state.free) != list(want.state.free):
        bad.append("free")
    return bad


def step_profile(spec, stream, device, pre_states, n_steps: int = 64) -> dict:
    """Kernels a translation step launches and their device time (by
    ``torch.profiler`` over ``n_steps`` eager steps of the stream's own
    machine, from the preconditioned drive), the host wall of an eager
    step, and one replay of the captured graph chunk: its device time
    (CUDA events) and host wall."""
    import torch
    from repro_torch.core import ftl_scan
    from repro_torch.core.trace import WRITE
    from repro_torch.core.workload import request_lpns, request_ops
    cls, arr, rid, pay = request_ops(stream)
    lpns = request_lpns(stream, spec.logical_pages)
    n = len(cls)
    host = ftl_scan._host_arrays(cls, arr, pay, rid, lpns,
                                 ftl_scan._bucket(n + spec.pages_per_block),
                                 device)
    m = ftl_scan._Machine(spec.blocks, spec.pages_per_block, 1,
                          host[0] == WRITE, host[1], host[4], n,
                          spec.gc_free_blocks, spec.gc_policy == "lru",
                          device)
    fs = ftl_scan.preconditioned_lanes([spec], device, pre_states)
    rec = ftl_scan._records(1, 3 * n_steps, device)
    for t in range(n_steps):
        fs = m.step(fs, rec, t)
    prof = profiled(lambda: [m.step(fs, rec, n_steps + t)
                             for t in range(n_steps)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n_steps):
        fs = m.step(fs, rec, 2 * n_steps + t)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / n_steps * 1e6
    chunk = ftl_scan._GraphChunk(m, fs, True)
    replay_ms = cuda_ms(chunk.replay, reps=3)
    replay_wall_ms = wall_ms(chunk.replay)
    out = {"eager_wall_us_per_step": wall_us,
           "graph_steps": ftl_scan._GRAPH,
           "graph_replay_device_ms": replay_ms,
           "graph_replay_wall_ms": replay_wall_ms}
    if prof["kernels"] == "not measured":
        out.update(kernels_per_step="not measured",
                   device_us_per_step="not measured")
    else:
        out.update(kernels_per_step=prof["kernels"] / n_steps,
                   device_us_per_step=prof["device_ms"] * 1e3 / n_steps)
    return out


def time_ftl_fold(mats, s0, kw) -> dict:
    """K1's FTL launch timed as the query takes it: its route (from the
    launch counts), one call between CUDA events, and its bound (the
    compact route's counted one; the dense count where the precondition
    sends it dense)."""
    from repro_torch.kernels.maxplus import kernel as K
    before = dict(K.LAUNCHES)
    K.maxplus_fold_kernel(mats, s0, **kw)
    route = "compact" if route_delta(before, "indexed")["compact"] else "dense"
    if route == "compact":
        f = time_fold(mats, s0, kw, dense=False)
        f.pop("out")
    else:
        ms = cuda_ms(lambda: K.maxplus_fold_kernel(mats, s0, **kw))
        t = kw["t_steps"]
        b, _, n, _ = mats.shape
        inputs = [x for x in (s0, kw.get("idx"), kw.get("arrivals"),
                              kw.get("extras"), kw.get("gvec"),
                              kw.get("wvec")) if x is not None]
        n_bytes = float(sum(x.numel() * x.element_size()
                            for x in (mats, *inputs, s0)))
        b_ms, b_by = bound_ms(n_bytes, 2.0 * t * b * n * n)
        f = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
             "bound_ms_dense_count": b_ms}
    f["route"] = route
    return f


def phase_ftl(device) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.api import FaultSpec, Simulator
    from repro_torch.core import ftl, ftl_scan
    from repro_torch.core.interface import InterfaceKind
    from repro_torch.core.maxplus_form import StateLayout, end_time_from_state
    from repro_torch.core.nand import CellType
    from repro_torch.core.sim import SSDConfig
    from repro_torch.core.workload import (iter_request_chunks,
                                           overwrite_stream)
    from repro_torch.kernels.maxplus import kernel as K
    from repro_torch.kernels.maxplus import ops as maxplus_ops
    from repro_torch.kernels.maxplus.ref import maxplus_fold_ref

    t_phase = time.perf_counter()
    cfg = SSDConfig(interface=InterfaceKind.PROPOSED, cell=CellType.SLC,
                    channels=WL_CHANNELS, ways=WL_WAYS)
    sim = Simulator(cfg, device=device)
    cpu = Simulator(cfg, device="cpu")
    layout = StateLayout(WL_CHANNELS, WL_WAYS)
    spec = ftl.FTLSpec(blocks=FTL_BLOCKS, pages_per_block=FTL_PPB,
                       overprovision=FTL_OP, gc_policy="greedy",
                       precondition=True)
    stream = overwrite_stream(FTL_REQUESTS, int(0.9 * spec.logical_pages),
                              read_fraction=FTL_READ_FRACTION, seed=FTL_SEED)
    prefix = dataclasses.replace(stream, **{
        f: getattr(stream, f)[:FTL_PREFIX]
        for f in ("arrival_us", "op_cls", "n_pages", "stream", "lpn")})
    waf_u = ftl.analytic_waf(spec.utilization)
    folds = FoldLog()
    try:
        # -- 11a: the translation alone, cold, against the numpy one ----
        # the session's cache of preconditioned drives, empty here: the
        # first translation ages the drive, later ones (and the queries)
        # start from a copy
        pre = sim._ftl_pre_states
        (tr_s, tr), ran = folds.on_card("translate_scan", lambda: timed(
            lambda: ftl_scan.translate_scan(stream, spec, device=device,
                                            pre_states=pre)))
        (pre_steps, pre_s), (win_steps, win_s) = (
            (c[2], c[3]) for c in ran if c[0] == "_drive")
        t0 = time.perf_counter()
        host = ftl.translate(stream, spec)
        host_s = time.perf_counter() - t0
        bad = same_translation(tr, host)
        if bad:
            raise AssertionError(f"translate_scan on the card != "
                                 f"ftl.translate in {bad}")
        warm_s, _ = timed(lambda: folds.on_card(
            "warm translate_scan",
            lambda: ftl_scan.translate_scan(stream, spec, device=device,
                                            pre_states=pre)))
        steps_prof = step_profile(spec, stream, device, pre)
        # the device's share of a translation: the kernels' own time a
        # step (profiled eager; a graph replays the same kernels) times
        # the steps, over the cold translation's wall
        d_us = steps_prof["device_us_per_step"]
        idle = ("not measured" if d_us == "not measured" else
                1.0 - d_us * 1e-6 * (pre_steps + win_steps) / tr_s)
        log(f"[11a] {cfg.describe()}: FTLSpec({spec.describe()}, "
            f"precondition: {len(ftl.precondition_lpns(spec))} writes), "
            f"overwrite_stream({FTL_REQUESTS}, {int(0.9 * spec.logical_pages)}"
            f", read_fraction={FTL_READ_FRACTION}) -> {tr.n_ops} ops "
            f"({tr.stats.gc_op_count} GC); translate_scan on the card "
            f"{tr_s:.2f} s cold (preconditioning {pre_steps} steps in "
            f"{pre_s:.2f} s = {pre_steps / pre_s:.0f} steps/s; the stream "
            f"{win_steps} steps in {win_s:.2f} s = {win_steps / win_s:.0f} "
            f"steps/s), {warm_s:.2f} s warm (the preconditioned drive "
            f"memoised); ftl.translate (numpy) {host_s:.2f} s; op-for-op "
            f"equal, stats and final drive state included; WAF "
            f"{tr.stats.waf:.4f} vs analytic_waf(u={spec.utilization:.4f}) "
            f"= {waf_u:.4f}")
        log(f"[11a] a translation step: {steps_prof['kernels_per_step']} "
            f"kernels, {steps_prof['device_us_per_step']} us of kernel time "
            f"(torch.profiler, eager steps), "
            f"{steps_prof['eager_wall_us_per_step']:.0f} us host wall eager;"
            f" one replay of the {ftl_scan._GRAPH}-step graph: "
            f"{steps_prof['graph_replay_device_ms']:.2f} ms device (CUDA "
            f"events), {steps_prof['graph_replay_wall_ms']:.2f} ms wall; the "
            f"device's idle share of the cold translation {idle}")

        # -- 11a: the query on cuda (the main path of K1's FTL launches) -
        torch.cuda.synchronize()
        rec = Recorder(maxplus_ops, "maxplus_fold_kernel")
        try:
            K.reset_launches()
            (cuda_s, res_cuda), ran = folds.on_card("cuda query", lambda: timed(
                lambda: sim.run(stream, ftl=spec, engine="cuda",
                                objective="all")))
            launches = dict(K.LAUNCHES)
        finally:
            rec.restore()
        if not (launches["indexed"] >= 1 and launches["periodic"]
                == launches["many"] == 0):
            raise AssertionError(f"the FTL query on cuda launched "
                                 f"{launches}")
        mats, s0 = rec.args
        kw = rec.kwargs
        k1_out = K.maxplus_fold_kernel(mats, s0, **kw)
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(maxplus_fold_ref(mats, s0,
                                                                 **kw)),
                           reps=1, warmup=False)
        plain_s = plain_ms / 1e3
        k1_plain = plain[0]
        k1_err = float((k1_out - k1_plain).abs().max())
        if not torch.equal(k1_out, k1_plain):
            raise AssertionError(f"K1 != plain on the FTL query's inputs "
                                 f"(max abs {k1_err})")
        k1_end = float(end_time_from_state(k1_out.cpu().numpy(), layout)[0])
        if k1_end != res_cuda.end_us:
            raise AssertionError(f"cuda FTL query end {res_cuda.end_us} != "
                                 f"its first K1 launch's {k1_end}")
        k1 = time_ftl_fold(mats, s0, kw)
        k1.update(plain_ms=plain_ms, max_abs_err=k1_err)
        del k1_plain, plain

        (scan_s, res_scan), _ = folds.on_card("scan query", lambda: timed(
            lambda: sim.run(stream, ftl=spec, engine="scan",
                            objective="all")), ("_drive", "_fold"))
        (oracle_s, res_oracle), _ = folds.on_card(
            "oracle query", lambda: timed(lambda: sim.run(
                stream, ftl=spec, engine="oracle", objective="all")))
        n_ops = res_scan.n_ops
        drift = rel(res_cuda.end_us, res_scan.end_us)
        agree = {r.engine: rel(r.end_us, res_oracle.end_us)
                 for r in (res_cuda, res_scan)}
        pct, pct_oracle = percentiles(res_scan), percentiles(res_oracle)
        pct_err = max(rel(pct[q], pct_oracle[q]) for q in pct)
        if not (n_ops == res_cuda.n_ops == res_oracle.n_ops == tr.n_ops
                and drift <= n_ops * F32_DRIFT_PER_OP
                and max(agree.values()) <= FTL_AGREEMENT
                and pct_err <= PERCENTILE_TOL
                and res_scan.gc_op_count > 0
                and res_scan.mb_s < res_scan.fresh_mb_s
                and res_cuda.waf == res_scan.waf == tr.stats.waf):
            raise AssertionError(
                f"FTL query: cuda vs scan {drift:.2e}, vs oracle {agree}, "
                f"percentiles {pct} vs {pct_oracle}, {res_scan.describe()}, "
                f"fresh {res_scan.fresh_mb_s}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre_card = sim.run(prefix, ftl=spec, engine="cuda")
        torch.cuda.synchronize()
        prefix_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pre_cpu = cpu.run(prefix, ftl=spec, engine="cuda")
        prefix_cpu_s = time.perf_counter() - t0
        if not (pre_card.end_us == pre_cpu.end_us
                and pre_card.fresh_mb_s == pre_cpu.fresh_mb_s
                and pre_card.ftl_stats == pre_cpu.ftl_stats):
            raise AssertionError(f"the {FTL_PREFIX}-request FTL prefix on the "
                                 f"card != the CPU: {pre_card.end_us} vs "
                                 f"{pre_cpu.end_us}")
        log(f"[11a] Simulator.run(stream, ftl=spec, objective='all'): cuda "
            f"{cuda_s:.2f} s (K1 {launches['indexed']} launches: "
            f"{launches['indexed/compact']} compact, "
            f"{launches['indexed/dense']} dense), scan {scan_s:.2f} s, "
            f"oracle {oracle_s:.2f} s; {n_ops} ops; cuda vs scan end "
            f"{drift:.2e} (< T*2^-24 = {n_ops * F32_DRIFT_PER_OP:.2e}); vs "
            f"the oracle {agree} (< {FTL_AGREEMENT}); scan vs oracle "
            f"percentiles {pct_err:.2e} (< {PERCENTILE_TOL}); aged "
            f"{res_scan.mb_s:.3f} MB/s vs fresh {res_scan.fresh_mb_s:.3f} "
            f"MB/s; {res_scan.describe()}")
        log(f"[11a] p50 / p99 / p99.9 {pct['p50_us']:.1f} / "
            f"{pct['p99_us']:.1f} / {pct['p99_9_us']:.1f} us; "
            f"{FTL_PREFIX}-request prefix ({pre_card.n_ops} ops) on cuda: "
            f"card {prefix_s:.2f} s, CPU {prefix_cpu_s:.2f} s, bit-equal")
        log(f"[11a] first K1 launch of the FTL query (B={mats.shape[0]} "
            f"M={mats.shape[1]} N={mats.shape[2]} T={kw['t_steps']}, 7 op "
            f"classes, arrivals) bit-equal to maxplus_fold_ref on the card "
            f"(plain {plain_s:.1f} s), its end time the query's: "
            f"{k1['route']} route {k1['ms']:.3f} ms"
            + (f" (pre-pass {k1['prepass_ms']:.3f} ms, fold alone "
               f"{k1['fold_ms']:.3f} ms, {k1['ns_per_step']:.1f} ns a step)"
               if k1["route"] == "compact" else "")
            + f", bound {k1['bound_ms']:.4f} ms ({k1['bound_by']})")

        # -- 11b: block failures (the host translator's path) -----------
        fspec = FaultSpec(**FTL_BLOCK_FAULTS)
        k1_before = K.LAUNCHES["indexed"]
        (fault_s, res_b), _ = folds.on_card("faulty query", lambda: timed(
            lambda: sim.run(prefix, ftl=spec, faults=fspec, engine="cuda")),
            ())
        if K.LAUNCHES["indexed"] == k1_before:
            raise AssertionError("11b priced its trace without K1")
        t0 = time.perf_counter()
        res_b_cpu = cpu.run(prefix, ftl=spec, faults=fspec, engine="cuda")
        fault_cpu_s = time.perf_counter() - t0
        tr_b = ftl.translate(prefix, spec,
                             prog_fail_prob=fspec.prog_fail_prob,
                             erase_fail_prob=fspec.erase_fail_prob,
                             fault_seed=fspec.seed)
        n_read = int(np.isin(tr_b.op_cls, (ftl.FTL_READ, ftl.GC_READ)).sum())
        st_b = res_b.ftl_stats
        if not (st_b.blocks_retired > 0
                and int(res_b.retry_hist.sum()) == n_read
                and res_b.end_us == res_b_cpu.end_us
                and res_b.ftl_stats == res_b_cpu.ftl_stats
                and np.array_equal(res_b.retry_hist, res_b_cpu.retry_hist)
                and res_b.n_ops == tr_b.n_ops):
            raise AssertionError(f"11b: {st_b}, retry_hist "
                                 f"{res_b.retry_hist} over {n_read} reads, "
                                 f"card {res_b.end_us} vs CPU "
                                 f"{res_b_cpu.end_us}")
        log(f"[11b] {FTL_PREFIX}-request prefix with FaultSpec("
            f"{FTL_BLOCK_FAULTS}) on cuda (the numpy translator's path): "
            f"{res_b.n_ops} ops, {st_b.prog_fails} program failures, "
            f"{st_b.blocks_retired} blocks retired, WAF {res_b.waf:.4f}; "
            f"retry_hist {res_b.retry_hist.tolist()} over {n_read} "
            f"read-class ops; card {fault_s:.2f} s, CPU {fault_cpu_s:.2f} s,"
            f" bit-equal")

        # -- 11c: chunked aging ------------------------------------------
        (chunk_s, rs), ran = folds.on_card("run_stream", lambda: timed(
            lambda: sim.run_stream(iter_request_chunks(stream, FTL_CHUNK),
                                   ftl=spec)), ("_drive", "_fold"))
        if not (rs.end_us == res_scan.end_us and rs.waf == res_scan.waf
                and rs.ftl_stats == res_scan.ftl_stats
                and rs.n_ops == res_scan.n_ops
                and rs.payload_bytes == res_scan.payload_bytes):
            raise AssertionError(f"run_stream(ftl=) != the one-shot scan "
                                 f"query: {rs.end_us} vs {res_scan.end_us}")
        chunk_steps, chunk_tr_s = translation_steps(ran)
        ospec = FaultSpec(**FTL_OP_FAULTS)
        head = dataclasses.replace(stream, **{
            f: getattr(stream, f)[:FTL_FAULT_CHUNKED]
            for f in ("arrival_us", "op_cls", "n_pages", "stream", "lpn")})
        (fchunk_s, rsf), _ = folds.on_card("run_stream faults", lambda: timed(
            lambda: sim.run_stream(iter_request_chunks(head, FTL_FAULT_CHUNK),
                                   ftl=spec, faults=ospec)),
            ("_drive", "_fold"))
        (fone_s, onef), _ = folds.on_card("one-shot faults", lambda: timed(
            lambda: sim.run(head, ftl=spec, faults=ospec)),
            ("_drive", "_fold"))
        if not (rsf.end_us == onef.end_us and rsf.waf == onef.waf
                and rsf.n_ops == onef.n_ops):
            raise AssertionError(f"run_stream(ftl=, faults=) != one-shot: "
                                 f"{rsf.end_us} vs {onef.end_us}")
        log(f"[11c] run_stream(iter_request_chunks(stream, {FTL_CHUNK}), "
            f"ftl=spec): {chunk_s:.2f} s ({chunk_steps} translation steps "
            f"in {chunk_tr_s:.2f} s), equal to 11a's one-shot scan query "
            f"(end, WAF, ftl_stats, {rs.n_ops} ops, {rs.payload_bytes} "
            f"bytes); with FaultSpec({FTL_OP_FAULTS}) on the first "
            f"{FTL_FAULT_CHUNKED} requests in chunks of {FTL_FAULT_CHUNK}: "
            f"chunked {fchunk_s:.2f} s == "
            f"one-shot {fone_s:.2f} s ({rsf.n_ops} ops)")

        # -- 11d: the aged design-space sweep ----------------------------
        ops_ = np.linspace(*FTL_SWEEP_OPS)
        specs = [ftl.FTLSpec(blocks=128, pages_per_block=32,
                             overprovision=float(op), precondition=True)
                 for op in ops_]
        aged = overwrite_stream(FTL_SWEEP_REQUESTS, specs[-1].logical_pages,
                                read_fraction=0.5, seed=FTL_SWEEP_SEED)
        (cold_s, ends), ran = folds.on_card("aged sweep", lambda: timed(
            lambda: sim.sweep(None, aged, ftl=specs)),
            ("_drive", "_trace_end_time_masked_impl"))
        sweep_steps, sweep_tr_s = translation_steps(ran)
        (warm_sweep_s, ends2), _ = folds.on_card("warm sweep", lambda: timed(
            lambda: sim.sweep(None, aged, ftl=specs)),
            ("_drive", "_trace_end_time_masked_impl"))
        runs = {}
        t0 = time.perf_counter()
        for i in FTL_SWEEP_RUN_POINTS:
            runs[i], _ = folds.on_card(f"point {i}", lambda: sim.run(
                aged, ftl=specs[i], engine="prefix"),
                ("_drive", "_trace_end_time_prefix_impl"))
        runs_s = time.perf_counter() - t0
        point_err = max(rel(ends[i], r.end_us) for i, r in runs.items())
        point_exact = all(ends[i] == r.end_us for i, r in runs.items())
        cpts = list(FTL_SWEEP_CPU_POINTS)
        t0 = time.perf_counter()
        ends_cpu = cpu.sweep(None, aged, ftl=[specs[i] for i in cpts])
        sweep_cpu_s = time.perf_counter() - t0
        if not (np.array_equal(ends, ends2) and np.array_equal(
                ends_cpu, ends[cpts]) and point_err <= FTL_AGREEMENT):
            raise AssertionError(f"aged sweep: warm == cold "
                                 f"{np.array_equal(ends, ends2)}, CPU "
                                 f"{ends_cpu} vs {ends[cpts]}, per point "
                                 f"{point_err:.2e}")
        log(f"[11d] sweep(None, overwrite_stream({FTL_SWEEP_REQUESTS}), "
            f"ftl={len(ops_)} points, OP {ops_[0]:.2f}..{ops_[-1]:.2f}, 128blk x "
            f"32pg): cold {cold_s:.2f} s ({sweep_steps} batched translation "
            f"steps in {sweep_tr_s:.2f} s), warm {warm_sweep_s:.2f} s, "
            f"equal; vs per-point run (prefix) on points "
            f"{list(FTL_SWEEP_RUN_POINTS)}: {point_err:.2e} (< "
            f"{FTL_AGREEMENT}; bit-equal: {point_exact}), {runs_s:.1f} s; "
            f"points {cpts} bit-equal to the CPU ({sweep_cpu_s:.1f} s); "
            f"WAF {runs[FTL_SWEEP_RUN_POINTS[0]].waf:.3f} at OP "
            f"{ops_[0]:.2f} .. {runs[FTL_SWEEP_RUN_POINTS[-1]].waf:.3f} at "
            f"{ops_[-1]:.2f}")

        # -- 11e: the WAF pin --------------------------------------------
        pin = ftl.FTLSpec(blocks=FTL_WAF_BLOCKS, pages_per_block=64,
                          overprovision=0.25, gc_free_blocks=1,
                          precondition=True, precondition_passes=3.0)
        (pin_s, tr_e), ran = folds.on_card("WAF pin", lambda: timed(
            lambda: ftl_scan.translate_scan(
                overwrite_stream(FTL_WAF_REQUESTS, pin.logical_pages,
                                 seed=FTL_WAF_SEED), pin, device=device)))
        pin_steps, _ = translation_steps(ran)
        want = ftl.analytic_waf(pin.utilization)
        pin_err = rel(tr_e.stats.waf, want)
        if pin_err > WAF_PIN_TOL:
            raise AssertionError(f"WAF pin: {tr_e.stats.waf} vs analytic "
                                 f"{want}")
        log(f"[11e] FTLSpec({pin.describe()}, gc_free_blocks=1, 3 "
            f"preconditioning passes) under overwrite_stream("
            f"{FTL_WAF_REQUESTS}): greedy WAF {tr_e.stats.waf:.4f} vs "
            f"analytic_waf(u={pin.utilization:.4f}) = {want:.4f} ({pin_err:.2%}"
            f" < {WAF_PIN_TOL:.0%}); {pin_steps} steps on the card in "
            f"{pin_s:.2f} s")
    finally:
        folds.restore()
    seconds = time.perf_counter() - t_phase
    log(f"[11] FTL in {seconds:.1f} s")
    return {"launches": launches, "k1": k1,
            "k1_shape": list(mats.shape) + [kw["t_steps"]],
            "seconds": seconds,
            "translation": {"cold_s": tr_s, "warm_s": warm_s,
                            "host_numpy_s": host_s,
                            "precondition_steps": pre_steps,
                            "precondition_s": pre_s,
                            "stream_steps": win_steps, "stream_s": win_s,
                            "idle_share": idle,
                            **steps_prof},
            "n_ops": n_ops, "gc_op_count": res_scan.gc_op_count,
            "waf": tr.stats.waf, "analytic_waf": waf_u,
            "mb_s": res_scan.mb_s, "fresh_mb_s": res_scan.fresh_mb_s,
            "walls_s": {"cuda": cuda_s, "scan": scan_s, "oracle": oracle_s,
                        "prefix_card": prefix_s, "prefix_cpu": prefix_cpu_s,
                        "faults_card": fault_s, "faults_cpu": fault_cpu_s,
                        "run_stream": chunk_s, "run_stream_faults": fchunk_s,
                        "one_shot_faults": fone_s, "sweep_cold": cold_s,
                        "sweep_warm": warm_sweep_s, "sweep_points": runs_s,
                        "sweep_cpu": sweep_cpu_s, "waf_pin": pin_s},
            "cuda_vs_scan": drift, "vs_oracle": agree,
            "percentiles": pct, "percentiles_oracle": pct_oracle,
            "k1_plain_s": plain_s,
            "faults": {"blocks_retired": st_b.blocks_retired,
                       "prog_fails": st_b.prog_fails,
                       "retry_hist": res_b.retry_hist.tolist()},
            "sweep": {"steps": sweep_steps, "translation_s": sweep_tr_s,
                      "vs_points": point_err, "points_exact": point_exact},
            "waf_pin": {"waf": tr_e.stats.waf, "analytic": want,
                        "steps": pin_steps}}


# ---------------------------------------------------------------------------
# phase 12: the storage tier
# ---------------------------------------------------------------------------


def bits_equal(a, b) -> bool:
    """Two tensors equal bit for bit (through an integer view of their
    width, so NaN payloads and signed zeros count)."""
    import torch
    raw = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    r = raw[a.element_size()]
    return torch.equal(a.view(r), b.view(r))


def storage_room(directory, need_disk: int, need_host: int) -> dict:
    """Free disk under ``directory`` and available host memory; raises
    when either is short of what phase 12 needs."""
    import os
    import shutil
    disk = shutil.disk_usage(directory).free
    host = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    if disk < need_disk or host < need_host:
        raise RuntimeError(
            f"phase 12 needs {need_disk / 1e9:.1f} GB of disk under "
            f"{directory} (free: {disk / 1e9:.1f}) and {need_host / 1e9:.1f} "
            f"GB of host memory (available: {host / 1e9:.1f})")
    return {"disk_free_gb": disk / 1e9, "host_available_gb": host / 1e9}


def card_steps(x, w, n: int, until=None) -> tuple[int, float]:
    """A training-like loop on the card: ``n`` steps (or, with ``until``,
    steps while ``until()`` holds), each eight small matmuls launched from
    Python and a synchronise; returns (steps, seconds)."""
    import torch
    steps, t0 = 0, time.perf_counter()
    while (steps < n) if until is None else until():
        y = x
        for _ in range(8):
            y = torch.tanh(y @ w)
        torch.cuda.synchronize()
        steps += 1
    return steps, time.perf_counter() - t0


@contextlib.contextmanager
def estimates_shared(module):
    """Inside, ``module.estimate_trace`` prices each (trace, config,
    options) once and hands that estimate back on a repeat: the planning
    loops of several budgets walk the same geometries."""
    real, memo = module.estimate_trace, {}

    def once(trace, cfg, **kw):
        key = (cfg, tuple(sorted(kw.items())), trace.channels, trace.ways,
               *(None if a is None else a.tobytes()
                 for a in (trace.cls, trace.channel, trace.way,
                           trace.parity, trace.payload, trace.arrival_us,
                           trace.extra_us)))
        if key not in memo:
            memo[key] = real(trace, cfg, **kw)
        return memo[key]

    module.estimate_trace = once
    try:
        yield memo
    finally:
        module.estimate_trace = real


def phase_storage(device, smi: str) -> dict:
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.api import Simulator
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.maxplus_form import StateLayout, end_time_from_state
    from repro_torch.core.nand import CellType
    from repro_torch.core.sched import lower_static
    from repro_torch.core.sim import SSDConfig
    from repro_torch.core.trace import checkpoint_trace
    from repro_torch.core.workload import checkpoint_requests
    from repro_torch.kernels.maxplus import kernel as K
    from repro_torch.kernels.maxplus import ops as maxplus_ops
    from repro_torch.kernels.maxplus.ref import maxplus_fold_ref
    from repro_torch.models.transformer import LayerSpec, init_params
    from repro_torch.storage import (CheckpointEngine, FileBackedTokens,
                                     PipeState, StripedTokenStore,
                                     pipeline_io_trace, place_on_device,
                                     plan_kv_offload)
    from repro_torch.storage import ssd_model
    from repro_torch.storage.checkpoint import _flatten
    from repro_torch.storage.ssd_model import (compare_interfaces,
                                               estimate_trace,
                                               estimate_trace_interfaces,
                                               plan_checkpoint_tier,
                                               plan_refill)

    t_phase = time.perf_counter()
    cfg = get_arch(LM_ARCH).config
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- 12a: checkpoint of RecurrentGemma-9B at CKPT_LAYERS layers -----
        params = init_params(dataclasses.replace(cfg, n_layers=CKPT_LAYERS),
                             torch.Generator(device=device).manual_seed(
                                 LM_SEED), device=device)
        leaves = _flatten(params)
        nbytes = sum(x.numel() * x.element_size() for x in leaves.values())
        room = storage_room(tmp, nbytes + 2 * PIPE_TOKENS * 4 + (1 << 30),
                            2 * nbytes + 2 * PIPE_TOKENS * 4)
        eng = CheckpointEngine(Path(tmp) / "ckpt", channels=CKPT_CHANNELS,
                               ways=CKPT_WAYS, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.save(CKPT_STEP, params, extra={"seed": LM_SEED})
        snap_s = time.perf_counter() - t0       # save returns after the snapshot
        res = eng.wait()
        save_s = time.perf_counter() - t0
        if res is None or res.step != CKPT_STEP or res.nbytes != nbytes:
            raise AssertionError(f"wait() after the save of step {CKPT_STEP} "
                                 f"returned {res}")
        manifest = json.loads((Path(tmp) / "ckpt" / f"step_{CKPT_STEP:08d}"
                                / "MANIFEST.json").read_text())
        n_chunks = sum(m["chunks"] for m in manifest["leaves"].values())
        ck_trace = lower_static(checkpoint_requests(nbytes, eng.ssd),
                                eng.ssd.channels, eng.ssd.ways).trace
        cpu_modeled = {k: e.seconds for k, e in estimate_trace_interfaces(
            ck_trace, eng.ssd, total_bytes=nbytes, device="cpu").items()}
        if res.modeled != cpu_modeled:
            raise AssertionError(f"modeled stall on the card {res.modeled} "
                                 f"!= the CPU session's {cpu_modeled}")
        t0 = time.perf_counter()
        step, host, extra = eng.restore(template=params)
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        placed = place_on_device(host, device)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        got = _flatten(placed)
        bad = [k for k, v in leaves.items()
               if got[k].device != v.device or not bits_equal(got[k], v)]
        if bad or list(got) != list(leaves) or step != CKPT_STEP \
                or extra != {"seed": LM_SEED}:
            raise AssertionError(f"restored checkpoint differs: {bad[:5]}, "
                                 f"step {step}, extra {extra}")
        del host, placed, got
        torch.cuda.empty_cache()
        shutil.rmtree(Path(tmp) / "ckpt")
        # a non-blocking save of part of the model while the card runs a
        # training-like loop: first at a new size (the stall is priced on
        # the writer thread, on the card), then at the same size (priced
        # once, reused)
        part, part_bytes = {}, 0
        for k, x in leaves.items():        # leaves in order to 1 GiB or more
            if part_bytes >= OVERLAP_BYTES:
                break
            part[k] = x
            part_bytes += x.numel() * x.element_size()
        xw = torch.randn(OVERLAP_DIM, OVERLAP_DIM, device=device,
                         dtype=torch.bfloat16,
                         generator=torch.Generator(device=device).manual_seed(
                             LM_SEED))
        card_steps(xw, xw, 4)
        alone_n, alone_s = card_steps(xw, xw, OVERLAP_STEPS)
        eng2 = CheckpointEngine(Path(tmp) / "overlap", channels=CKPT_CHANNELS,
                                ways=CKPT_WAYS, device=device)
        overlap = {}
        for k, label in enumerate(("priced", "reused")):
            t0 = time.perf_counter()
            eng2.save(CKPT_STEP + 1 + k, part)
            snap = time.perf_counter() - t0
            n_, s_ = card_steps(xw, xw, 0, until=eng2.writing)
            r = eng2.wait()
            if r is None or r.step != CKPT_STEP + 1 + k \
                    or r.nbytes != part_bytes or n_ == 0:
                raise AssertionError(f"overlapped save {label}: {r}, "
                                     f"{n_} steps")
            overlap[label] = {"snapshot_s": snap, "write_wall_s": r.wall_s,
                              "steps": n_, "step_ms": s_ / n_ * 1e3,
                              "modeled_s": r.modeled}
        if overlap["reused"]["modeled_s"] != overlap["priced"]["modeled_s"]:
            raise AssertionError(f"the reused stall differs: {overlap}")
        n_part = len(part)
        del params, leaves, part, xw
        torch.cuda.empty_cache()
        shutil.rmtree(Path(tmp) / "overlap")
        alone_ms = alone_s / alone_n * 1e3
        out["checkpoint"] = {
            "bytes": nbytes, "leaves": len(manifest["leaves"]),
            "chunks": n_chunks, "snapshot_s": snap_s,
            "write_wall_s": res.wall_s, "save_to_wait_s": save_s,
            "pricing_s": save_s - snap_s - res.wall_s,
            "restore_s": restore_s, "place_s": place_s,
            "modeled_s": res.modeled, **room,
            "overlap": {"leaves": n_part, "bytes": part_bytes,
                        "step_ms_alone": alone_ms, **overlap}}
        log(f"[12a] CheckpointEngine(channels={CKPT_CHANNELS}, ways="
            f"{CKPT_WAYS}, device='{device.type}').save({CKPT_STEP}, "
            f"{LM_ARCH} params at {CKPT_LAYERS} layers):"
            f" {nbytes} bytes ({nbytes / 1e9:.2f} GB) in "
            f"{len(manifest['leaves'])} leaves, {n_chunks} chunks over "
            f"{CKPT_CHANNELS} channel directories; snapshot card -> host "
            f"{snap_s:.2f} s ({nbytes / snap_s / 1e9:.2f} GB/s), write wall "
            f"{res.wall_s:.2f} s ({nbytes / res.wall_s / 1e9:.2f} GB/s), "
            f"save to wait() {save_s:.2f} s (the stall pricing on the "
            f"writer thread about {save_s - snap_s - res.wall_s:.2f} s); "
            f"wait() returned this step's "
            f"SaveResult; restore {restore_s:.2f} s, place_on_device "
            f"{place_s:.2f} s; every leaf bit-equal on the card; modeled "
            f"stall on {eng.ssd.describe()} "
            + ", ".join(f"{k} {v:.2f} s" for k, v in res.modeled.items())
            + f", equal to the CPU session's; disk free "
            f"{room['disk_free_gb']:.1f} GB, host memory available "
            f"{room['host_available_gb']:.1f} GB; card: {smi}")
        log(f"[12a] non-blocking saves of the first {n_part} leaves "
            f"({part_bytes / 1e9:.2f} GB) while the card runs a loop of 8 "
            f"bf16 {OVERLAP_DIM}^2 matmuls a step: alone {alone_ms:.3f} ms a "
            f"step; " + "; ".join(
                f"stall {k} ({v['snapshot_s']:.2f} s snapshot, write "
                f"{v['write_wall_s']:.2f} s): {v['steps']} steps at "
                f"{v['step_ms']:.3f} ms ({v['step_ms'] / alone_ms:.2f}x)"
                for k, v in overlap.items())
            + f"; the reused stall equals the priced one; card: {smi}")

        # -- 12b: the token pipeline feeding the card --------------------
        t0 = time.perf_counter()
        tokens = np.random.default_rng(PIPE_SEED).integers(
            0, cfg.vocab_size, PIPE_TOKENS, dtype=np.int32)
        store = StripedTokenStore.write(Path(tmp) / "tokens", tokens,
                                        channels=PIPE_SHARDS)
        del tokens
        make_s = time.perf_counter() - t0
        pipe = FileBackedTokens(store, PIPE_BATCH, PIPE_SEQ, ways=PIPE_WAYS)
        it = iter(pipe)
        blocked = 0.0
        kept = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(PIPE_BATCHES):
            if i == PIPE_RESUME_AT:
                resume = pipe.state()
            t1 = time.perf_counter()
            batch = next(it)
            blocked += time.perf_counter() - t1
            on_card = {k: v.to(device) for k, v in batch.items()}
            if i % PIPE_CHECK_EVERY == 0 or i == PIPE_RESUME_AT:
                kept[i] = batch
        torch.cuda.synchronize()
        feed_s = time.perf_counter() - t0
        pipe.close()
        if on_card["inputs"].shape != (PIPE_BATCH, PIPE_SEQ):
            raise AssertionError(f"batch shape {on_card['inputs'].shape}")
        again = FileBackedTokens(store, PIPE_BATCH, PIPE_SEQ, ways=PIPE_WAYS)
        again.restore(PipeState(resume.cursor))
        first = next(iter(again))
        again.close()
        if not all(torch.equal(first[k], kept[PIPE_RESUME_AT][k])
                   for k in first):
            raise AssertionError("resume from PipeState gave another batch")
        # each batch against plain numpy reads of the shards at the
        # pipeline's offsets (a hedged row reads the next shard)
        shards = [np.load(s, mmap_mode="r") for s in store.shards]
        need, replica_rows = PIPE_SEQ + 1, 0
        for i, batch in kept.items():
            rows = batch["inputs"].numpy()
            for b in range(PIPE_BATCH):
                g = i * PIPE_BATCH + b
                for hedge in (0, 1):
                    m = shards[(g % PIPE_SHARDS + hedge) % PIPE_SHARDS]
                    off = (g // PIPE_SHARDS) * need % max(1, len(m) - need)
                    if np.array_equal(rows[b], m[off:off + need - 1]):
                        replica_rows += hedge
                        break
                else:
                    raise AssertionError(f"batch {i} row {b} is no read of "
                                         "the store")
        if replica_rows > pipe.hedged_reads:
            raise AssertionError(f"{replica_rows} rows from replicas, "
                                 f"{pipe.hedged_reads} hedged reads")
        pipe_trace = pipeline_io_trace(pipe, PIPE_BATCHES)
        pipe_ssd = SSDConfig(channels=pipe_trace.channels,
                             ways=pipe_trace.ways)
        pipe_bytes = PIPE_BATCHES * PIPE_BATCH * need * 4
        t1 = time.perf_counter()
        pipe_est = estimate_trace(pipe_trace, pipe_ssd, total_bytes=pipe_bytes,
                                  device=device)
        pipe_est_s = time.perf_counter() - t1
        if pipe_est != estimate_trace(pipe_trace, pipe_ssd,
                                      total_bytes=pipe_bytes, device="cpu"):
            raise AssertionError("the pipeline's estimate on the card != the "
                                 "CPU session's")
        n_tok = PIPE_BATCHES * PIPE_BATCH * PIPE_SEQ
        out["pipeline"] = {
            "tokens": PIPE_TOKENS, "shards": PIPE_SHARDS,
            "batches": PIPE_BATCHES, "make_store_s": make_s,
            "feed_s": feed_s, "tokens_per_s_page_cached": n_tok / feed_s,
            "next_blocked_s": blocked, "hedged_reads": pipe.hedged_reads,
            "replica_rows": replica_rows, "estimate_s": pipe_est_s,
            "modeled_s": pipe_est.seconds,
            "modeled_mb_s": pipe_est.bandwidth_mb_s}
        log(f"[12b] StripedTokenStore of {PIPE_TOKENS} int32 tokens "
            f"({PIPE_TOKENS * 4 / 2**30:.0f} GiB) over {PIPE_SHARDS} shards "
            f"(made and written in {make_s:.2f} s); FileBackedTokens(batch="
            f"{PIPE_BATCH}, seq={PIPE_SEQ}, ways={PIPE_WAYS}): "
            f"{PIPE_BATCHES} batches onto the card in {feed_s:.2f} s "
            f"({n_tok / feed_s:.0f} tokens/s, an upper bound: the store was "
            f"just written and is read from the page cache, not the disk), "
            f"next() blocked {blocked:.3f} "
            f"s in all, {pipe.hedged_reads} hedged reads; resume from "
            f"PipeState({resume.cursor}) gave the same batch; {len(kept)} "
            f"batches equal to numpy reads of the shards; "
            f"pipeline_io_trace({PIPE_BATCHES}) ({pipe_trace.n_ops} ops on "
            f"{pipe_ssd.describe()}) priced in {pipe_est_s:.2f} s on the card"
            f", equal to the CPU session's: {pipe_est.describe()}")

    # -- 12c: KV-offload planning ---------------------------------------
    def unwindow(specs):
        return tuple(LayerSpec(**{**dataclasses.asdict(s), "window": None})
                     for s in specs)
    global_cfg = dataclasses.replace(cfg, pattern=unwindow(cfg.pattern),
                                     tail=unwindow(cfg.tail))
    t0 = time.perf_counter()
    local = plan_kv_offload(cfg, KV_SEQ, device=device)
    t1 = time.perf_counter()
    kv = plan_kv_offload(global_cfg, KV_SEQ, device=device)
    kv_s = time.perf_counter() - t1
    kv_cpu = plan_kv_offload(global_cfg, KV_SEQ, device="cpu")
    n_global = sum(s.mixer == "attn" for s in global_cfg.pattern) \
        * global_cfg.num_units
    kv_token = 2 * cfg.n_kv_heads * cfg.hd * 2       # bf16 K and V
    if not (not local.applicable and "inapplicable" in local.note
            and kv.applicable and kv.tokens_per_s == kv_cpu.tokens_per_s
            and kv.cold_bytes_per_seq == n_global * kv_token * KV_SEQ
            and kv.tokens_per_s["proposed"] > kv.tokens_per_s["conv"]):
        raise AssertionError(f"KV-offload plans: {local.note} / {kv.note}, "
                             f"card {kv.tokens_per_s} vs CPU "
                             f"{kv_cpu.tokens_per_s}")
    out["kv_offload"] = {"local_note": local.note, "note": kv.note,
                         "global_attention_layers": n_global,
                         "cold_bytes_per_seq": kv.cold_bytes_per_seq,
                         "tokens_per_s": kv.tokens_per_s, "plan_s": kv_s,
                         "local_plan_s": t1 - t0}
    log(f"[12c] plan_kv_offload({LM_ARCH}, {KV_SEQ}) on 4 x 8 MLC: "
        f"{local.note} ({t1 - t0:.3f} s); with every attention window set "
        f"to None ({n_global} global-attention layers, "
        f"{kv.cold_bytes_per_seq // KV_SEQ} bytes a token, "
        f"{kv.cold_bytes_per_seq / 1e9:.2f} GB a sequence): tokens/s "
        + ", ".join(f"{k} {v:.4f}" for k, v in kv.tokens_per_s.items())
        + f" ({kv.trace.n_ops}-op window, {kv_s:.2f} s on the card), equal "
        "to the CPU session's")

    # -- 12d: the example's planning flows ------------------------------
    # its KV-offload loop (examples/ssd_design_space.py:188) over the
    # three ids it names, each plan equal to a CPU session's
    kv_loop = {}
    for arch in KV_ARCHS:
        t0 = time.perf_counter()
        plan = plan_kv_offload(get_arch(arch).config, KV_SEQ, device=device)
        plan_s = time.perf_counter() - t0
        want = plan_kv_offload(get_arch(arch).config, KV_SEQ, device="cpu")
        bad = [f for f in KV_FIELDS if getattr(plan, f) != getattr(want, f)]
        if bad or plan.applicable != (arch == "qwen2-0.5b"):
            raise AssertionError(f"12d KV offload of {arch} on the card != "
                                 f"the CPU in {bad}: {plan.note}")
        kv_loop[arch] = {"note": plan.note, "applicable": plan.applicable,
                         "tokens_per_s": plan.tokens_per_s, "plan_s": plan_s}
        log(f"[12d] plan_kv_offload({arch}, {KV_SEQ}) on the card "
            f"({plan_s:.2f} s), equal to the CPU session's: {plan.note}")
    out["kv_offload_loop"] = kv_loop
    ssd_model.reset_estimates()
    t0 = time.perf_counter()
    with estimates_shared(ssd_model):
        stall = {b: plan_checkpoint_tier(PLAN_CKPT_BYTES, b, device=device)
                 for b in PLAN_BUDGETS}
    stall_s = time.perf_counter() - t0
    stall_n = dict(ssd_model.ESTIMATES)
    ssd_model.reset_estimates()
    t0 = time.perf_counter()
    with estimates_shared(ssd_model):
        refill = {**plan_refill(REFILL_BYTES, 60.0, device=device),
                  "compare": compare_interfaces(REFILL_BYTES, "read",
                                                device=device)}
    refill_s = time.perf_counter() - t0
    refill_n = dict(ssd_model.ESTIMATES)
    ests, ops_, est_s = (stall_n[k] + refill_n[k]
                         for k in ("calls", "ops", "seconds"))
    # one 4096-op estimate alone, then profiled: the card's busy share of
    # its wall
    one_cfg = SSDConfig(cell=CellType.MLC, channels=4, ways=8)
    one_tr = checkpoint_trace(PLAN_CKPT_BYTES, one_cfg)
    prof_s, _ = timed(lambda: estimate_trace(one_tr, one_cfg, device=device))
    prof = profiled(lambda: estimate_trace(one_tr, one_cfg, device=device))
    t0 = time.perf_counter()
    cpu_stall = plan_checkpoint_tier(PLAN_CKPT_BYTES, PLAN_CPU_BUDGET,
                                     device="cpu")
    cpu_compare = compare_interfaces(REFILL_BYTES, "read", device="cpu")
    cpu_s = time.perf_counter() - t0
    if not (stall[PLAN_CPU_BUDGET] == cpu_stall
            and refill["compare"] == cpu_compare):
        raise AssertionError(f"12d on the card != the CPU: "
                             f"{stall[PLAN_CPU_BUDGET]} vs {cpu_stall}")
    tiers = [p and p.config.cell for p in stall.values()]
    if tiers != [CellType.MLC, CellType.SLC, None]:
        raise AssertionError(f"12d checkpoint tiers {tiers} for the budgets "
                             f"{PLAN_BUDGETS}: not MLC, SLC, none")
    if not (refill["trace"] and refill["bytes"] and refill["energy"]
            and refill["energy"].energy_joules
            <= refill["trace"].energy_joules):
        raise AssertionError(f"refill plans {refill}")
    busy = ("not measured" if prof["device_ms"] == "not measured"
            else prof["device_ms"] / 1e3 / prof_s)
    out["plans"] = {
        "checkpoint_stall": {b: p and p.describe() for b, p in stall.items()},
        "refill": {k: refill[k].describe() for k in ("trace", "bytes",
                                                     "energy")},
        "compare": {k: [e.seconds, e.energy_joules]
                    for k, e in refill["compare"].items()},
        "stall_s": stall_s, "refill_s": refill_s, "estimates": ests,
        "estimate_ops": ops_, "estimate_s": est_s,
        "scan_ops_per_s": ops_ / est_s, "one_estimate": {
            "wall_s": prof_s, **prof, "device_busy_share": busy},
        "cpu_check_s": cpu_s}
    log(f"[12d] checkpoint-stall plans for {PLAN_CKPT_BYTES} bytes (MLC, then"
        f" SLC): " + "; ".join(
            f"{b:.0f} s -> {p.describe() if p else 'no geometry fits'}"
            for b, p in stall.items())
        + f" ({stall_s:.1f} s, {stall_n['calls']} estimates)")
    log(f"[12d] {REFILL_BYTES >> 30} GiB dataloader refill: trace-planned "
        f"{refill['trace'].describe()}; byte-planned "
        f"{refill['bytes'].describe()}; min-energy "
        f"{refill['energy'].describe()}; compare_interfaces: "
        + ", ".join(f"{k} {e.seconds:.1f} s {e.energy_joules * 1e3:.1f} mJ"
                    for k, e in refill["compare"].items())
        + f" ({refill_s:.1f} s, {refill_n['calls']} estimates)")
    log(f"[12d] {ests} estimate_trace calls on the card folded {ops_} ops "
        f"on the scan engine in {est_s:.1f} s ({ops_ / est_s:.0f} ops/s); "
        f"one 4096-op estimate: {prof_s:.3f} s wall, {prof['kernels']} "
        f"kernels, {prof['device_ms']} ms device time (busy share {busy}); "
        f"the {PLAN_CPU_BUDGET:.0f} s plan and every compare_interfaces row "
        f"equal to a CPU session's ({cpu_s:.1f} s)")

    # -- 12e: K1 on the storage traces (its main path here) --------------
    priced = (("checkpoint", ck_trace, eng.ssd),
              ("pipeline", pipe_trace, pipe_ssd),
              ("kv_offload", kv.trace, SSDConfig(cell=CellType.MLC,
                                                 channels=4, ways=8)))
    rec = Recorder(maxplus_ops, "maxplus_fold_kernel")
    try:
        K.reset_launches()
        cuda_res = {}
        t0 = time.perf_counter()
        for name, tr, ssd in priced:
            cuda_res[name] = Simulator.for_config(ssd, device).run(
                tr, engine="cuda", objective="all")
        torch.cuda.synchronize()
        k1_wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        rec.restore()
    if not (launches["indexed"] >= len(priced)
            and launches["indexed/compact"] == launches["indexed"]
            and launches["periodic"] == launches["many"] == 0):
        raise AssertionError(f"K1 on the storage traces launched {launches}")
    drift = {}
    for name, tr, ssd in priced:
        scan = Simulator.for_config(ssd, device).run(tr, objective="all")
        got = cuda_res[name]
        errs = [rel(got.end_us, scan.end_us)] + [
            rel(getattr(got.energy, f), getattr(scan.energy, f))
            for f in ("cmd_j", "io_j", "ecc_j", "ctrl_j", "array_j")
            if getattr(scan.energy, f) != 0.0]
        drift[name] = max(errs)
        if drift[name] > tr.n_ops * F32_DRIFT_PER_OP:
            raise AssertionError(f"{name}: cuda vs scan {errs} (bar "
                                 f"{tr.n_ops * F32_DRIFT_PER_OP:.2e})")
    mats, s0 = rec.args
    kw = rec.kwargs
    k1_out = K.maxplus_fold_kernel(mats, s0, **kw)
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(maxplus_fold_ref(mats, s0, **kw)),
                       reps=1, warmup=False)
    outs = k1_out if isinstance(k1_out, tuple) else (k1_out,)
    plains = plain[0] if isinstance(plain[0], tuple) else (plain[0],)
    k1_err = max(float((a - b).abs().max()) for a, b in zip(outs, plains))
    if not all(torch.equal(a, b) for a, b in zip(outs, plains)):
        raise AssertionError(f"K1 != plain on the checkpoint trace's inputs "
                             f"(max abs {k1_err})")
    layout = StateLayout(ck_trace.channels, ck_trace.ways)
    k1_end = float(end_time_from_state(outs[0].cpu().numpy(), layout)[0])
    if k1_end != cuda_res["checkpoint"].end_us:
        raise AssertionError(f"checkpoint trace on cuda ends at "
                             f"{cuda_res['checkpoint'].end_us}, its K1 "
                             f"launch at {k1_end}")
    k1 = time_ftl_fold(mats, s0, kw)
    k1.update(plain_ms=plain_ms, max_abs_err=k1_err)
    log(f"[12e] K1 on the storage traces (Simulator.run(engine='cuda', "
        f"objective='all')): {launches['indexed']} launches, all compact, "
        f"{k1_wall:.2f} s; cuda vs scan (end time and op energies) "
        + ", ".join(f"{k} {v:.2e}" for k, v in drift.items())
        + f" (< T*2^-24); the first launch (checkpoint trace, B="
        f"{mats.shape[0]} M={mats.shape[1]} N={mats.shape[2]} "
        f"T={kw['t_steps']}) bit-equal to maxplus_fold_ref (plain "
        f"{plain_ms:.1f} ms), its end time the query's: {k1['route']} route "
        f"{k1['ms']:.4f} ms, bound {k1['bound_ms']:.6f} ms "
        f"({k1['bound_by']})")
    seconds = time.perf_counter() - t_phase
    log(f"[12] storage tier in {seconds:.1f} s")
    return {"launches": launches, "k1": k1,
            "k1_shape": list(mats.shape) + [kw["t_steps"]],
            "k1_wall_s": k1_wall, "cuda_vs_scan": drift,
            "seconds": seconds, **out}


# ---------------------------------------------------------------------------
# phase 13: the rest of slice H's serving path — the nine other configs,
# the MoE FFN and the xLSTM blocks — through the port's ServingEngine
# ---------------------------------------------------------------------------


def vl_position_ids(b: int, n_text: int, grid: int, n_after: int, device):
    """[3, B, S] M-RoPE ids as Qwen2-VL's frontend lays them out:
    ``n_text`` text tokens, a ``grid`` x ``grid`` patch grid at temporal
    id ``n_text`` with its row and column added to the height and width
    ids, then ``n_after`` text tokens from one past the largest id."""
    import torch
    text = torch.arange(n_text)
    rows, cols = torch.arange(grid * grid) // grid, torch.arange(
        grid * grid) % grid
    image = torch.stack([torch.full((grid * grid,), n_text), n_text + rows,
                         n_text + cols])
    after = int(image.max()) + 1 + torch.arange(n_after)
    ids = torch.cat([torch.stack([text] * 3), image,
                     torch.stack([after] * 3)], dim=1)
    return ids.to(torch.int32)[:, None].expand(3, b, ids.shape[1]).to(
        device).contiguous()


class RouteLog:
    """Wraps ``moe.apply_moe`` and ``moe._routing_tables``.  For every
    call: whether it was a prefill (S > 1), its groups, tokens a group,
    top_k and the (token, expert) pairs kept; for the first ``keep``
    calls (all with ``keep=None``) also the router, the layer's input as
    grouped and the tables, as they were."""

    def __init__(self, keep=None):
        from repro_torch.models import moe
        self.moe, self.keep = moe, keep
        self.apply, self.tables = moe.apply_moe, moe._routing_tables
        self.calls, self.kept = [], []
        moe.apply_moe, moe._routing_tables = self._apply, self._tables

    def _apply(self, p, spec, x, **kw):
        b, s, d = x.shape
        full = self.keep is None or len(self.calls) < self.keep
        self.calls.append({"prefill": s > 1, "k": spec.top_k})
        if full:
            self.calls[-1].update(router=p["router"], x=(
                x if s > 1 else x.reshape(1, b, d)).clone())
        return self.apply(p, spec, x, **kw)

    def _tables(self, ids, weights, spec, cap):
        src, wtab = self.tables(ids, weights, spec, cap)
        g, t, k = ids.shape
        call = self.calls[-1]
        call.update(groups=g, tokens=t, pairs=g * t * k,
                    kept=int((src < t).sum()))
        if "x" in call:
            call.update(src=src, wtab=wtab)
        return src, wtab

    def restore(self):
        self.moe.apply_moe, self.moe._routing_tables = self.apply, \
            self.tables


def hold_routes(card_call: dict, cpu_call: dict) -> int:
    """The margin rule on one MoE call, card against CPU: tokens whose
    k-th and (k+1)-th float32 router logits (the CPU's) differ by more
    than ROUTE_TIE_REL of the largest |logit| have the same experts and
    slots, weights within ROUTE_WEIGHT_TOL (the router's float32 sums run
    in another order), and every group without a near-tie the same
    ``src`` table; the near-tie tokens are counted, and must be under
    1 %.  Returns (near ties, [G, T] near-tie mask)."""
    import torch
    from repro_torch.models import moe
    logits = moe.router_logits(cpu_call["router"].cpu(),
                               cpu_call["x"].cpu())
    k = cpu_call["k"]
    top = torch.sort(logits, dim=-1, descending=True).values
    ties = top[..., k - 1] - top[..., k] <= ROUTE_TIE_REL * \
        logits.abs().max()
    t = logits.shape[1]
    placed = []
    for call in (card_call, cpu_call):
        src, wtab = call["src"].cpu(), call["wtab"].cpu()
        g, e, c = src.shape
        slot = torch.zeros((g, t + 1, e), dtype=torch.int64)
        w = torch.zeros((g, t + 1, e))
        gi, ei, ci = torch.meshgrid(torch.arange(g), torch.arange(e),
                                    torch.arange(c), indexing="ij")
        slot[gi, src, ei] = ci + 1
        w[gi, src, ei] = wtab
        placed.append((slot[:, :t], w[:, :t], src))
    (cs, cw, csrc), (ps, pw, psrc) = placed
    ok = ~ties
    w_err = float((cw - pw)[ok].abs().max()) if ok.any() else 0.0
    clean = ~ties.any(1)
    if not (torch.equal(cs[ok], ps[ok]) and w_err <= ROUTE_WEIGHT_TOL
            and torch.equal(csrc[clean], psrc[clean])
            and int(ties.sum()) < 0.01 * ties.numel()):
        raise AssertionError(f"MoE routing on the card != the CPU beyond the"
                             f" margin rule: weights {w_err:.2e}, "
                             f"{int(ties.sum())} near ties")
    return int(ties.sum()), ties


def phase13_smoke(device) -> dict:
    """13a: the nine SMOKE models at float32 compute, the same parameters
    on the card and the CPU, against the CPU's plain path."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill)
    from repro_torch.serve import ServingEngine

    out = {}
    for arch in H_SMOKES:
        cfg = dataclasses.replace(get_arch(arch).smoke, compute_dtype="f32")
        cpu_p = init_params(cfg, 0, device="cpu")
        card_p = to_device(cpu_p, device)
        n_attn = cfg.num_units * sum(sp.mixer == "attn"
                                     for sp in cfg.pattern)
        rng = np.random.default_rng(0)
        runs = {}
        for name, dev, p in (("card", device, card_p),
                             ("cpu", torch.device("cpu"), cpu_p)):
            routes = RouteLog()
            FK.reset_launches()
            RK.reset_launches()
            try:
                with torch.inference_mode():
                    if cfg.input_mode == "embeddings":
                        emb = torch.as_tensor(np.random.default_rng(1)
                                              .standard_normal((3, 25, cfg.d_model))
                                              .astype(np.float32), device=dev)
                        logits, cache = prefill(cfg, p, emb[:, :21],
                                                max_seq=25)
                        steps = [logits[:, -1].cpu()]
                        for pos in range(21, 25):
                            logits, cache = decode_step(
                                cfg, p, cache, emb[:, pos:pos + 1], pos)
                            steps.append(logits[:, -1].cpu())
                        runs[name] = {"steps": torch.stack(steps, 1)}
                    else:
                        prompts = [np.random.default_rng(2).integers(
                            0, cfg.vocab_size, n).tolist() for n in (21, 17, 9)]
                        res = ServingEngine(cfg, p, max_seq=40,
                                            device=dev).generate(prompts, 12)
                        runs[name] = {"tokens": res.tokens,
                                      "logits": res.prefill_logits}
                    if cfg.rope_kind == "mrope":
                        ids = vl_position_ids(2, 5, 4, 4, dev)
                        toks = torch.as_tensor(np.random.default_rng(3)
                                               .integers(0, cfg.vocab_size,
                                                         (2, 25))
                                               .astype(np.int32), device=dev)
                        logits, cache = prefill(cfg, p, toks, max_seq=29,
                                                position_ids=ids)
                        steps = [logits[:, -1].cpu()]
                        top = int(ids.max()) + 1
                        for i in range(4):
                            tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
                            step_ids = torch.full((3, 2, 1), top + i,
                                                  dtype=torch.int32,
                                                  device=dev)
                            logits, cache = decode_step(
                                cfg, p, cache, tok[:, None].to(torch.int32),
                                25 + i, position_ids=step_ids)
                            steps.append(logits[:, -1].cpu())
                        runs[name]["vl_steps"] = torch.stack(steps, 1)
            finally:
                routes.restore()
            runs[name]["routes"] = routes.calls
            runs[name]["launches"] = {**FK.LAUNCHES, **RK.LAUNCHES}
        card, cpu = runs["card"], runs["cpu"]
        want_k4 = n_attn * (2 if cfg.rope_kind == "mrope" else 1)
        launches = card["launches"]
        if launches != {FK.TC: 0, FK.F32: want_k4, **{
                key: 0 for key in RK.LAUNCHES}}:
            raise AssertionError(f"{arch} SMOKE on the card launched "
                                 f"{launches}, expected {want_k4} of "
                                 f"{FK.F32} and nothing else")
        errs = {}
        for key in ("steps", "logits", "vl_steps"):
            if key in cpu:
                got, want = (torch.as_tensor(np.asarray(r[key]))
                             [..., :cfg.vocab_size] for r in (card, cpu))
                errs[key] = float((got - want).abs().max()) / float(
                    want.abs().max())
                if errs[key] > 1e-4 or not torch.equal(
                        got.argmax(-1), want.argmax(-1)):
                    raise AssertionError(f"{arch} SMOKE {key} on the card: "
                                         f"{errs[key]:.2e} of the largest "
                                         f"logit, or a greedy token differs")
        if "tokens" in cpu and not np.array_equal(card["tokens"],
                                                  cpu["tokens"]):
            raise AssertionError(f"{arch} SMOKE: generated tokens differ")
        ties = 0
        if cfg.moe is not None:
            if len(card["routes"]) != len(cpu["routes"]):
                raise AssertionError(f"{arch}: MoE calls differ")
            ties = sum(hold_routes(a, b)[0] for a, b in
                       zip(card["routes"], cpu["routes"]))
        out[arch] = {"k4_f32_launches": launches[FK.F32],
                     "rel_err": max(errs.values()), "moe_calls":
                     len(card["routes"]), "route_near_ties": ties}
        log(f"[13a] {cfg.name} (f32 compute) on the card vs the CPU's "
            f"plain path: " + ("generate 12 greedy tokens x 3 prompts "
                               "identical, " if "tokens" in cpu else
                               "prefill + 4 decode steps on embeddings, ")
            + ("non-text M-RoPE ids prefill + 4 steps, "
               if "vl_steps" in cpu else "")
            + f"logits within {max(errs.values()):.2e} of the largest (bar "
            f"1e-4); {launches[FK.F32]} launches of {FK.F32} (head dim "
            f"{cfg.hd}{', zero-padded to 16' if cfg.hd < 16 else ''})"
            + (f"; {len(card['routes'])} MoE calls, routing tables under "
               f"the margin rule, {ties} near-tie tokens"
               if cfg.moe is not None else ""))
    return out


def hold_k4(label, args, kwargs) -> dict:
    """The first K4 launch of a prefill against its plain version within
    FLASH_TOL, then timed (``time_k4``)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_reference
    q, k, v = args
    with torch.inference_mode():
        got = FK.flash_attention_bhsd(q, k, v, **kwargs)
        want = attention_reference(q, k, v, **kwargs)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rel_err = flash_err(got, want)
        del want
        if rel_err > FLASH_TOL[str(q.dtype)]:
            raise AssertionError(f"{label}: flash kernel on the prefill's "
                                 f"inputs {rel_err:.2e} > "
                                 f"{FLASH_TOL[str(q.dtype)]}")
        t = time_k4(q, k, v, kwargs, got)
    return {"max_abs_err": err, "rel_err": rel_err, "shape": list(q.shape),
            "kv_shape": list(k.shape), "dtype": str(q.dtype), **t}


def log_k4(label: str, t: dict) -> None:
    log(f"[{label}] K4 at q {tuple(t['shape'])} k/v {tuple(t['kv_shape'])} "
        f"{t['dtype']}: first prefill launch within {t['max_abs_err']:.3e} "
        f"({t['rel_err']:.2e} relative, bar "
        f"{FLASH_TOL['torch.bfloat16']}) of its plain version; tensor-core "
        f"kernel {t['ms']:.3f} ms ({t['computed_flops'] / t['ms'] / 1e9:.1f}"
        f" TFLOP/s computed, {t['ops'] / t['ms'] / 1e9:.1f} needed, "
        f"{100 * t['bound_ms'] / t['ms']:.1f} % of the bound), plain "
        f"{t['plain_ms']:.3f} ms, CUDA-core route on f32 copies "
        f"{t['f32_route_ms']:.3f} ms, SDPA with the causal mask "
        f"{t['library_ms']} ms, SDPA is_causal {t['sdpa_is_causal_ms']} ms,"
        f" bound {t['bound_ms']:.4f} ms ({t['bound_by']})")


def phase_lm_configs(device) -> dict:
    """13a-13e: the SMOKE models of the nine other configs against the
    CPU; qwen2-0.5b, granite-moe-3b-a800m, qwen2-vl-2b and xlstm-350m at
    full width and depth on the card."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.models import moe
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.transformer import decode_step, prefill

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[13] device memory at the start: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    out = {"smoke": phase13_smoke(device)}

    def full(arch, want_k4):
        cfg = get_arch(arch).config
        params, n, n_bytes, init_s = lm_params(cfg, device)
        n_attn = cfg.num_units * sum(sp.mixer == "attn"
                                     for sp in cfg.pattern)
        if n_attn != want_k4:
            raise AssertionError(f"{arch}: {n_attn} attention layers")
        log(f"[13] {cfg.name}: {n / 1e9:.3f} B parameters, "
            f"{n_bytes / 1e9:.2f} GB on the card, initialised from seed "
            f"{LM_SEED} in {init_s:.1f} s")
        return cfg, params, {"n_params": n, "param_gb": n_bytes / 1e9,
                             "init_s": init_s}

    def tc_only(label, wave, n):
        want = {FK.TC: n, FK.F32: 0, **{key: 0 for key in RK.LAUNCHES}}
        if wave["launches"] != want:
            raise AssertionError(f"{label}: the prefill launched "
                                 f"{wave['launches']}, expected {want}")

    # -- 13b: qwen2-0.5b, dense GQA 14:2 at D = 64 ----------------------
    cfg, params, stats = full("qwen2-0.5b", 24)
    wave = serve_wave(cfg, params, device)
    tc_only("13b", wave, 24)
    log_wave("13b", wave)
    del params
    torch.cuda.empty_cache()
    k4 = hold_k4("13b", wave.pop("k4_args"), wave.pop("k4_kwargs"))
    log_k4("13b", k4)
    out["qwen2-0.5b"] = {**stats, **wave, "k4": k4}

    # -- 13c: granite-moe-3b-a800m, 40 experts top-8 --------------------
    cfg, params, stats = full("granite-moe-3b-a800m", 32)
    routes = RouteLog(keep=1)
    try:
        wave = serve_wave(cfg, params, device)
    finally:
        routes.restore()
    tc_only("13c", wave, 32)
    log_wave("13c", wave)
    pre = [c for c in routes.calls if c["prefill"]]
    if len(pre) != 32:
        raise AssertionError(f"13c: {len(pre)} MoE calls in the prefill")
    dropped = [1.0 - c["kept"] / c["pairs"] for c in pre]
    first = routes.calls[0]
    layer = {k: v[0] for k, v in params["unit"]["layer0"]["ffn"].items()}
    with torch.inference_mode():
        card_y = moe.apply_moe(layer, cfg.moe, first["x"],
                               compute_dtype=cfg.cdtype).cpu()
        t0 = time.perf_counter()
        cpu_routes = RouteLog()
        try:
            cpu_y = moe.apply_moe({k: v.cpu() for k, v in layer.items()},
                                  cfg.moe, first["x"].cpu(),
                                  compute_dtype=cfg.cdtype)
        finally:
            cpu_routes.restore()
        cpu_s = time.perf_counter() - t0
    ties, tie_mask = hold_routes(first, cpu_routes.calls[0])
    ok = ~tie_mask
    y_err = float((card_y.float() - cpu_y.float())[ok].abs().max())
    y_scale = float(cpu_y.float().abs().max())
    if y_err > 2.0 ** -5 * y_scale:
        raise AssertionError(f"13c: first MoE layer on the card vs the CPU "
                             f"{y_err:.3e} of {y_scale:.3f}")
    del params, layer, routes, first, cpu_routes
    torch.cuda.empty_cache()
    k4 = hold_k4("13c", wave.pop("k4_args"), wave.pop("k4_kwargs"))
    log(f"[13c] dropped (token, expert) pairs a prefill layer: min "
        f"{min(dropped):.4f}, mean {statistics.mean(dropped):.4f}, max "
        f"{max(dropped):.4f} (capacity {moe.group_capacity(cfg.moe, 4, max(LM_PROMPT_LENS))} "
        f"slots an expert a row); the first MoE layer on its recorded input"
        f": routing tables under the margin rule ({ties} near-tie tokens of"
        f" {tie_mask.numel()}), outputs within {y_err:.3e} of the CPU's "
        f"(bar 2^-5 x {y_scale:.3f}; the CPU's layer {cpu_s:.1f} s)")
    log_k4("13c", k4)
    out["granite-moe-3b-a800m"] = {
        **stats, **wave, "k4": k4, "dropped_share": dropped,
        "route_near_ties": ties, "moe_layer_err": y_err,
        "moe_layer_scale": y_scale}

    # -- 13d: qwen2-vl-2b, D = 128, non-text M-RoPE ids -----------------
    cfg, params, stats = full("qwen2-vl-2b", 28)
    b, s = VL_BATCH, VL_SEQ
    n_after = s - VL_TEXT - VL_GRID * VL_GRID
    ids = vl_position_ids(b, VL_TEXT, VL_GRID, n_after, device)
    toks = torch.as_tensor(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32), device=device)
    rec = Recorder(flash_ops, "flash_attention_bhsd")
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            FK.reset_launches()
            RK.reset_launches()
            t0 = time.perf_counter()
            logits, cache = prefill(cfg, params, toks,
                                    max_seq=s + VL_DECODE,
                                    position_ids=ids)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            launches = {**FK.LAUNCHES, **RK.LAUNCHES}
            top = int(ids.max()) + 1
            t0 = time.perf_counter()
            new = []
            for i in range(VL_DECODE):
                tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
                new.append(tok)
                logits, cache = decode_step(
                    cfg, params, cache, tok[:, None].to(torch.int32), s + i,
                    position_ids=torch.full((3, b, 1), top + i,
                                            dtype=torch.int32, device=device))
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            finite = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    finally:
        rec.restore()
    tc_only("13d", {"launches": launches}, 28)
    if not finite or rec.args[0].shape[-1] != 128:
        raise AssertionError(f"13d: logits finite {finite}, K4 head dim "
                             f"{rec.args[0].shape[-1]}")
    del params, cache, logits
    torch.cuda.empty_cache()
    k4 = hold_k4("13d", rec.args, rec.kwargs)
    vl = {"prefill_s": prefill_s, "decode_s": decode_s,
          "decode_tokens_per_s": b * VL_DECODE / decode_s,
          "peak_device_gb": peak_gb, "launches": launches}
    log(f"[13d] {cfg.name} prefill at B={b} S={s} with Qwen2-VL's M-RoPE "
        f"ids ({VL_TEXT} text tokens, a {VL_GRID} x {VL_GRID} patch grid at "
        f"one temporal id, {n_after} text tokens from id {top - n_after}): "
        f"{prefill_s:.3f} s; {VL_DECODE} decode steps {decode_s:.3f} s "
        f"({vl['decode_tokens_per_s']:.1f} tokens/s); peak device memory "
        f"{peak_gb:.2f} GB; launches {launches}")
    log_k4("13d", k4)
    out["qwen2-vl-2b"] = {**stats, **vl, "k4": k4}

    # -- 13e: xlstm-350m, 7:1 mLSTM:sLSTM, no attention -----------------
    cfg, params, stats = full("xlstm-350m", 0)
    scan_s = {"prefill": 0.0, "decode": 0.0}
    real_scan = xlstm_mod._slstm_scan

    def timed_scan(p, spec, x, xc, state):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_scan(p, spec, x, xc, state)
        torch.cuda.synchronize()
        scan_s["prefill" if x.shape[1] > 1 else "decode"] += \
            time.perf_counter() - t
        return res

    xlstm_mod._slstm_scan = timed_scan
    try:
        wave = serve_wave(cfg, params, device)
        wave_scan = dict(scan_s)
    finally:
        xlstm_mod._slstm_scan = real_scan
    tc_only("13e", wave, 0)
    log_wave("13e", wave)
    x = torch.as_tensor(np.random.default_rng(LM_SEED + 1).integers(
        0, cfg.vocab_size, (XL_BATCH, XL_SEQ + 1)).astype(np.int32),
        device=device)
    with torch.inference_mode():
        whole, _ = prefill(cfg, params, x, max_seq=XL_SEQ + 1)
        _, cache = prefill(cfg, params, x[:, :XL_SEQ], max_seq=XL_SEQ + 1)
        step, _ = decode_step(cfg, params, cache, x[:, XL_SEQ:], XL_SEQ)
        whole, step = (a[..., :cfg.vocab_size].float() for a in (whole,
                                                                 step))
        xl_err = float((whole - step).abs().max())
        xl_scale = float(whole.abs().max())
        same = float((whole.argmax(-1) == step.argmax(-1)).float().mean())
    if not (np.isfinite(xl_err) and xl_err <= XL_TOL * xl_scale):
        raise AssertionError(f"13e: prefill({XL_SEQ + 1}) vs prefill("
                             f"{XL_SEQ}) + decode_step: {xl_err:.3e} of "
                             f"{xl_scale:.3f}")
    del params, cache, whole, step, x
    torch.cuda.empty_cache()
    n_slstm = cfg.num_units * sum(sp.mixer == "slstm" for sp in cfg.pattern)
    log(f"[13e] the sLSTM scans (a Python step a token, {n_slstm} blocks) "
        f"took {wave_scan['prefill']:.2f} s of the {wave['prefill_s']:.2f} s"
        f" prefill and {wave_scan['decode']:.2f} s of the "
        f"{wave['decode_s']:.2f} s decode; prefill of {XL_SEQ + 1} tokens "
        f"vs prefill of {XL_SEQ} + one decode_step at B={XL_BATCH} "
        f"(chunkwise vs step): logits within {xl_err:.3e} of "
        f"{xl_scale:.3f} (bar {XL_TOL} of the largest), greedy tokens "
        f"equal on {100 * same:.0f} % of rows")
    out["xlstm-350m"] = {**stats, **wave, "slstm_scan_s": wave_scan,
                         "chunkwise_vs_step_err": xl_err,
                         "chunkwise_vs_step_scale": xl_scale}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[13] the rest of slice H's serving path in {out['seconds']:.1f} s")
    return out


def rel_max(got, want) -> float:
    """max |got - want| over max |want| (float32)."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def bwd_small_cases():
    """(b, h, kvh, s, d, causal, window, dtype) of 14a: phase 8a's small
    cases with Sq = Sk (the backward takes self-attention only), then the
    slice's shape classes in both dtypes: D 8 (zero-padded to 16), 64,
    128, 256; no window and windows 300 and 2048 (biting at S = 1000 and
    2100); groups 1, 7, 12, 16; ragged S 100 and 1000."""
    import torch
    cases = [(b, h, kvh, sq, d, causal, window, dt)
             for b, h, kvh, sq, sk, d, causal, window, dt
             in flash_small_cases() if sq == sk]
    for dt in (torch.float32, torch.bfloat16):
        cases += [(1, 7, 1, 100, 8, True, None, dt),
                  (1, 14, 2, 1000, 64, True, None, dt),
                  (1, 14, 2, 1000, 64, True, 300, dt),
                  (1, 12, 1, 1000, 128, True, 2048, dt),
                  (1, 16, 1, 1000, 256, True, 2048, dt),
                  (1, 16, 1, 2100, 256, True, 2048, dt)]
    return cases


def check_flash_bwd(device) -> dict:
    """14a for K4: the forward's lse against ``attention_lse_reference``
    (and its output unchanged by asking for lse), dq, dk, dv of the
    backward kernels against ``attention_backward_reference`` within
    FLASH_BWD_TOL, two calls bit-equal, each counted once in all and once
    on its dtype's route; then ``ops.flash_attention``'s gradient on the
    grouped layout (B = 2, bf16) against the CPU's plain one."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_lse_reference)
    cases = bwd_small_cases()
    worst = {str(torch.float32): 0.0, str(torch.bfloat16): 0.0}
    lse_worst = 0.0
    FK.reset_launches()
    for i, (b, h, kvh, s, d, causal, window, dt) in enumerate(cases):
        routes = dict(FK.BACKWARD_LAUNCHES)
        g = torch.Generator(device=device).manual_seed(100 + i)
        q, k, v, do = (torch.randn(shape, generator=g, device=device).to(dt)
                       for shape in ((b, h, s, d), (b, kvh, s, d),
                                     (b, kvh, s, d), (b, h, s, d)))
        kw = dict(causal=causal, window=window)
        o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
        if not torch.equal(o, FK.flash_attention_bhsd(q, k, v, **kw)):
            raise AssertionError(f"14a case {i}: asking for lse changed the "
                                 "forward's output")
        got = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
        again = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
        key = FK.BWD_ROUTES[FK.route(dt)]
        if FK.BACKWARD_LAUNCHES != {**routes, FK.BWD: routes[FK.BWD] + 2,
                                    key: routes[key] + 2}:
            raise AssertionError(f"14a case {i} {cases[i]}: backward routes "
                                 f"{routes} -> {FK.BACKWARD_LAUNCHES}")
        want = attention_backward_reference(q, k, v, o, do, **kw)
        want_lse = attention_lse_reference(q, k, **kw)
        torch.cuda.synchronize()
        lse_err = rel_max(lse, want_lse)
        errs = [rel_max(x, y) for x, y in zip(got, want)]
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"14a case {i} {cases[i]}: two backward "
                                 "calls differ")
        if lse_err > LSE_TOL or max(errs) > FLASH_BWD_TOL[str(dt)]:
            raise AssertionError(f"14a case {i} {cases[i]}: lse {lse_err:.2e}"
                                 f" (bar {LSE_TOL}), dq/dk/dv {errs} (bar "
                                 f"{FLASH_BWD_TOL[str(dt)]})")
        worst[str(dt)] = max(worst[str(dt)], max(errs))
        lse_worst = max(lse_worst, lse_err)
    n_bwd = FK.BACKWARD_LAUNCHES[FK.BWD]
    if n_bwd != 2 * len(cases):
        raise AssertionError(f"14a: {n_bwd} backward calls counted, "
                             f"expected {2 * len(cases)}")
    by_route = {k: v for k, v in FK.BACKWARD_LAUNCHES.items() if k != FK.BWD}
    # ops.flash_attention's Function on the grouped layout [B, S, kvH, G, D]
    g = torch.Generator(device=device).manual_seed(99)
    xs = [torch.randn(shape, generator=g, device=device).bfloat16()
          for shape in ((2, 300, 2, 7, 64), (2, 300, 2, 64), (2, 300, 2, 64))]
    do = torch.randn(xs[0].shape, generator=g, device=device).bfloat16()
    grads = []
    for ins in (xs, [x.cpu().float() for x in xs]):
        ins = [x.clone().requires_grad_(True) for x in ins]
        out = flash_attention(*ins, window=100)
        grads.append(torch.autograd.grad(out, ins, do.to(out)))
    torch.cuda.synchronize()
    grouped = max(rel_max(x.cpu(), y) for x, y in zip(*grads))
    if (grouped > FLASH_BWD_TOL[str(torch.bfloat16)]
            or FK.BACKWARD_LAUNCHES[FK.BWD_ROUTES[FK.TC]]
            != by_route[FK.BWD_ROUTES[FK.TC]] + 1):
        raise AssertionError(f"14a grouped layout: {grouped:.2e} (bar "
                             f"{FLASH_BWD_TOL[str(torch.bfloat16)]}), "
                             f"launches {FK.BACKWARD_LAUNCHES}")
    log(f"[14a] K4 backward on {len(cases)} cases (D 8-256, groups 1-16, "
        f"S 64-2100, windows none-2048, both dtypes; routes {by_route}): "
        f"grouped layout through ops.flash_attention within "
        f"{grouped:.2e}; dq/dk/dv within "
        f"{worst[str(torch.float32)]:.2e} (f32, bar "
        f"{FLASH_BWD_TOL[str(torch.float32)]}) and "
        f"{worst[str(torch.bfloat16)]:.2e} (bf16, bar "
        f"{FLASH_BWD_TOL[str(torch.bfloat16)]}) of the largest magnitude, "
        f"lse within {lse_worst:.2e} (bar {LSE_TOL}); two calls bit-equal; "
        f"{n_bwd} backward calls, forward launches {dict(FK.LAUNCHES)}")
    return {"cases": len(cases), "rel_err": worst, "lse_rel_err": lse_worst,
            "routes": by_route, "grouped_rel_err": grouped}


def check_rglru_bwd(device) -> dict:
    """14a for K5: ``rglru_scan_backward`` (one launch of K5's reverse
    mode) bit-equal to ``rglru_scan_backward_ref`` on both routes: R = 37
    f32 and R = 100 bf16 row pitches TMA cannot read take the simple
    kernel, the rest (14d's [1, 4096, 4096] among them) the ring."""
    import torch
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import plan as RP
    from repro_torch.kernels.rglru.ref import rglru_scan_backward_ref
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((3, 37, 37, f32), RP.SIMPLE), ((2, 129, 100, bf16), RP.SIMPLE),
             ((2, 300, 4096, f32), RP.RING), ((2, 129, 200, bf16), RP.RING),
             ((1, 4096, 4096, f32), RP.RING), ((4, 1, 520, f32), RP.RING)]
    routes = {RP.RING: 0, RP.SIMPLE: 0}
    for i, ((b, s, r, dt), route) in enumerate(cases):
        a, x = rglru_inputs(b, s, r, dt, 200 + i, device)
        h = RK.rglru_scan_kernel(a, x)
        dh = torch.randn(a.shape, generator=torch.Generator(
            device=device).manual_seed(300 + i), device=device).to(dt)
        before = dict(RK.LAUNCHES)
        da, db = RK.rglru_scan_backward(a, h, dh)
        torch.cuda.synchronize()
        key = RK.ROUTE_KEYS[route]
        if RK.LAUNCHES != {**before, key: before[key] + 1,
                           RK.TOTAL: before[RK.TOTAL] + 1}:
            raise AssertionError(f"14a K5 backward {cases[i]}: route counts "
                                 f"{before} -> {RK.LAUNCHES}")
        want_da, want_db = rglru_scan_backward_ref(a, h, dh)
        if not (torch.equal(da, want_da) and torch.equal(db, want_db)):
            raise AssertionError(f"14a K5 backward {cases[i]} differs from "
                                 "its plain version")
        routes[route] += 1
    log(f"[14a] K5 backward (one reverse launch a call) bit-equal to "
        f"rglru_scan_backward_ref on {len(cases)} shapes ({routes[RP.RING]} "
        f"on the ring, {routes[RP.SIMPLE]} on the simple route)")
    return {"cases": len(cases), "routes": routes}


class plain_kernels:
    """While active, the model's attention and RG-LRU scan run the
    kernels' plain versions, differentiable: ``attention_reference``
    under autograd, the plain scan with its plain backward.  The
    yardstick of 14b and 14d, never the path."""

    def __enter__(self):
        import torch
        from repro_torch.kernels.flash_attention.ref import attention_reference
        from repro_torch.kernels.rglru import ops as rglru_ops
        from repro_torch.kernels.rglru.ref import (rglru_scan_backward_ref,
                                                   rglru_scan_ref)
        from repro_torch.models import attention as attn_mod

        class PlainScan(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a, b):
                h = rglru_scan_ref(a, b)
                ctx.save_for_backward(a, h)
                return h

            @staticmethod
            def backward(ctx, dh):
                return rglru_scan_backward_ref(*ctx.saved_tensors,
                                               dh.contiguous())

        def attend(spec, q, k, v, positions, plan=None):
            b, s, kvh, g, d = q.shape
            o = attention_reference(q.reshape(b, s, kvh * g, d).transpose(1, 2),
                                    k.transpose(1, 2), v.transpose(1, 2),
                                    causal=True, window=spec.window,
                                    q_pos=positions, k_pos=positions,
                                    softcap=spec.softcap)
            return o.transpose(1, 2).reshape(q.shape)

        self.saved = (attn_mod, attn_mod.attend, rglru_ops,
                      rglru_ops.rglru_linear_scan)
        attn_mod.attend = attend
        rglru_ops.rglru_linear_scan = lambda a, b: PlainScan.apply(
            a.contiguous(), b.contiguous())
        return self

    def __exit__(self, *exc):
        attn_mod, attend, rglru_ops, scan = self.saved
        attn_mod.attend = attend
        rglru_ops.rglru_linear_scan = scan
        return False


def kernel_counts() -> dict:
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    return {**FK.LAUNCHES, **FK.BACKWARD_LAUNCHES, **RK.LAUNCHES,
            **RK.BACKWARD_LAUNCHES}


def reset_kernel_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    FK.reset_launches()
    RK.reset_launches()


def grads_against_plain(label, cfg, params, batch, accum) -> dict:
    """Loss and gradients of one step's batch with the kernels, then with
    their plain versions on the card (no kernel launched), compared: the
    loss, the global norm and every leaf (relative L2 distance)."""
    import torch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.train.optimizer import global_norm, tree_paths
    reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, grads = loss_and_grads(cfg, params, batch, accum)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    counts = kernel_counts()
    norm = float(global_norm(grads))
    t0 = time.perf_counter()
    with plain_kernels():
        ploss, _, pgrads = loss_and_grads(cfg, params, batch, accum)
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if kernel_counts() != counts:
        raise AssertionError(f"{label}: the plain step launched a kernel")
    pnorm = float(global_norm(pgrads))
    leaf_err, worst_leaf = 0.0, None
    for (path, g), (_, p) in zip(tree_paths(grads), tree_paths(pgrads)):
        # relative to the leaf's norm, or to LEAF_FLOOR of the global norm
        # where the leaf's gradient is smaller (the key bias: a row's
        # softmax cannot see it, so its gradient is rounding noise)
        e = float(torch.linalg.vector_norm(g.float() - p.float())
                  / max(float(torch.linalg.vector_norm(p.float())),
                        LEAF_FLOOR * pnorm))
        if e > leaf_err:
            leaf_err, worst_leaf = e, "/".join(path)
    n_leaves = len(list(tree_paths(grads)))
    del grads, pgrads
    out = {"loss": float(loss), "plain_loss": float(ploss),
           "grad_norm": norm, "plain_grad_norm": pnorm,
           "loss_rel": abs(float(loss) - float(ploss)) / abs(float(ploss)),
           "norm_rel": abs(norm - pnorm) / pnorm, "leaf_rel": leaf_err,
           "worst_leaf": worst_leaf, "leaves": n_leaves,
           "kernel_s": kernel_s, "plain_s": plain_s, "launches": counts}
    if not (math.isfinite(out["loss"]) and math.isfinite(norm)):
        raise AssertionError(f"{label}: loss {loss} / grad norm {norm}")
    if (out["loss_rel"] > TRAIN_LOSS_TOL or out["norm_rel"] > TRAIN_NORM_TOL
            or leaf_err > TRAIN_LEAF_TOL):
        raise AssertionError(f"{label}: kernels vs plain versions: {out}")
    log(f"[{label}] loss {out['loss']:.6f} vs plain {out['plain_loss']:.6f} "
        f"({out['loss_rel']:.2e}, bar {TRAIN_LOSS_TOL}); grad norm "
        f"{norm:.6f} vs {pnorm:.6f} ({out['norm_rel']:.2e}, bar "
        f"{TRAIN_NORM_TOL}); worst of {n_leaves} gradient leaves "
        f"{leaf_err:.2e} relative L2 ({worst_leaf}; bar {TRAIN_LEAF_TOL}, "
        f"floor {LEAF_FLOOR} of the global norm); "
        f"{kernel_s:.2f} s with the kernels ({counts}), {plain_s:.2f} s "
        "plain")
    return out


#: the port's kernels a training step runs, as ``profiled`` names them
STEP_KERNELS = ("flash_fwd_tc", "flash_bwd_prep", "flash_bwd_dkdv_tc",
                "flash_bwd_sum", "flash_bwd_dq_tc", "rglru_scan_ring",
                "rglru_scan_ring_bwd")


def step_split(label, fn, step_s) -> dict:
    """Where one training step's device time goes: every kernel of one
    call of ``fn`` by name (``profiled``, device activity only), the
    port's own (STEP_KERNELS) apart.  (A window holding only the port's
    ctypes-launched kernels, timed alone after other profiler sessions
    in the process, was seen to record no device event; a whole step's
    window records them.)"""
    t0 = time.perf_counter()
    split = profiled(fn, cpu=False)["by_name"]
    profiled_s = time.perf_counter() - t0
    if not isinstance(split, dict):
        log(f"[{label}] one step's kernels: not measured")
        return {}
    out = {"step_device_ms": sum(split.values()),
           "step_kernels_ms": dict(sorted(split.items(),
                                          key=lambda kv: -kv[1])[:12]),
           "step_ours_ms": {k: split[k] for k in STEP_KERNELS
                            if k in split}}
    log(f"[{label}] one step's kernels by torch.profiler ({profiled_s:.2f} "
        f"s with the profiler): {out['step_device_ms']:.1f} ms of device "
        f"time against the step's {1e3 * step_s:.1f} ms; the port's "
        f"{out['step_ours_ms']} ms; the largest {out['step_kernels_ms']} ms")
    return out


def time_k4_bwd(q, k, v, window) -> dict:
    """K4's backward at one shape: one call between CUDA events (median
    of 3), its plain version, the error against it, SDPA's backward
    (forward plus backward minus forward; ``is_causal`` without a window,
    the boolean mask with one) on the same inputs with the kv heads
    repeated, and the operations bound: five products over the kept
    pairs, 10 D flops a pair; and the forward with ``lse`` that the
    step runs before it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference)
    b, h, s, d = q.shape
    o, lse = FK.flash_attention_bhsd(q, k, v, window=window, with_lse=True)
    do = torch.randn(q.shape, generator=torch.Generator(
        device=q.device).manual_seed(7), device=q.device).to(q.dtype)
    got = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, window=window)
    want = attention_backward_reference(q, k, v, o, do, window=window)
    torch.cuda.synchronize()
    err = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(got, want))
    rel = max(rel_max(x, y) for x, y in zip(got, want))
    if rel > FLASH_BWD_TOL[str(q.dtype)]:
        raise AssertionError(f"K4 backward at {tuple(q.shape)}: {rel:.2e}")
    del got, want
    t = {"max_abs_err": err, "rel_err": rel, "shape": list(q.shape),
         "kv_shape": list(k.shape), "window": window,
         "ms": cuda_ms(lambda: FK.flash_attention_bwd_bhsd(
             q, k, v, o, do, lse, window=window)),
         "fwd_lse_ms": cuda_ms(lambda: FK.flash_attention_bhsd(
             q, k, v, window=window, with_lse=True)),
         "plain_ms": cuda_ms(lambda: attention_backward_reference(
             q, k, v, o, do, window=window), warmup=False)}
    group = h // k.shape[1]
    xs = [x.detach().requires_grad_(True) for x in (
        q, k.repeat_interleave(group, dim=1), v.repeat_interleave(group, 1))]
    if window:
        pos = torch.arange(s, device=q.device)
        kw = {"attn_mask": (pos[:, None] >= pos[None, :])
              & (pos[:, None] - pos[None, :] < window)}
    else:
        kw = {"is_causal": True}
    t["library_ms"] = None
    try:             # the yardstick only, never the path
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(*xs, **kw))
        both = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*xs, **kw), xs, do))
        t["library_ms"] = both - fwd
        t["library_fwd_ms"] = fwd
    except RuntimeError as exc:
        log(f"SDPA backward yardstick failed: {exc}")
    del xs
    t["pairs"] = valid_pairs(s, s, True, window, 0)
    t["ops"] = 10.0 * d * t["pairs"] * b * h
    t["bytes"] = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + lse.numel() * 4
    t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["ops"], ops_per_s=(
        BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S))
    return t


def time_k5_bwd(a, h) -> dict:
    """K5's backward at one shape: ``rglru_scan_backward`` (its outputs
    allocated, then one reverse launch) as one call between CUDA events,
    its plain version, the bytes bound (a, h and dh read, da and db
    written), and the reverse kernel's launch alone into outputs made
    beforehand (``scan_ms``)."""
    import torch
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru import plan as RP
    from repro_torch.kernels.rglru.ref import rglru_scan_backward_ref
    dh = torch.randn(a.shape, generator=torch.Generator(
        device=a.device).manual_seed(8), device=a.device).to(a.dtype)
    t = {"ms": cuda_ms(lambda: RK.rglru_scan_backward(a, h, dh)),
         "plain_ms": cuda_ms(lambda: rglru_scan_backward_ref(a, h, dh),
                             warmup=False),
         "bytes": 5.0 * a.numel() * a.element_size(), "shape": list(a.shape)}
    t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], 3.0 * a.numel())
    da, db = torch.empty_like(a), torch.empty_like(a)
    p = RP.plan_bwd(*a.shape, a.element_size(),
                    [x.data_ptr() for x in (a, h, dh, da, db)])
    t["route"] = p.route
    t["scan_ms"] = cuda_ms(lambda: RK.launch_bwd(a, h, dh, da, db, p))
    return t


def train_run(cfg, device) -> dict:
    """14c: ``Trainer.run()`` from a fresh state (seed LM_SEED, 14b's):
    TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_ACCUM microbatches, WSD, a
    checkpoint every TRAIN_CKPT_EVERY steps, a failure injected before
    step TRAIN_FAIL_AT + 1, one restart; each step timed (and whether a
    save was being written), the saves' snapshots and the restore timed."""
    import tempfile

    import torch
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.dryrun import model_flops
    from repro_torch.launch.steps import abstract_train_state
    from repro_torch.storage.datapipe import SyntheticTokens
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.schedules import wsd
    from repro_torch.train.trainer import Trainer, TrainerConfig

    state_bytes = sum(x.numel() * x.element_size() for x in _leaves(
        abstract_train_state(cfg, OptConfig())))
    with tempfile.TemporaryDirectory() as tmp:
        room = storage_room(tmp, 3 * state_bytes, 2 * state_bytes)
        data = SyntheticTokens(cfg.vocab_size, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ, seed=LM_SEED)
        tr = Trainer(cfg, TrainerConfig(
            steps=TRAIN_STEPS, log_every=1, ckpt_every=TRAIN_CKPT_EVERY,
            ckpt_dir=tmp, grad_accum=TRAIN_ACCUM), data, ocfg=OptConfig(),
            schedule=wsd(*TRAIN_WSD),
            injector=FailureInjector(fail_at_steps=(TRAIN_FAIL_AT,)),
            device=device)
        steps, saves, restores = [], [], []
        step_fn, save_fn = tr._step, tr.ckpt.save
        restore_fn = tr.ckpt.restore

        def timed_step(st, batch):
            writing = tr.ckpt.writing()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(st, batch)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0, writing))
            return out

        def timed_save(*args, **kw):
            t0 = time.perf_counter()
            save_fn(*args, **kw)
            saves.append(time.perf_counter() - t0)

        def timed_restore(*args, **kw):
            t0 = time.perf_counter()
            out = restore_fn(*args, **kw)
            restores.append(time.perf_counter() - t0)
            return out

        tr._step, tr.ckpt.save, tr.ckpt.restore = (timed_step, timed_save,
                                                   timed_restore)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        t0 = time.perf_counter()
        res = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        del tr
    hist = res["history"]
    n_first = TRAIN_FAIL_AT
    replay = hist[n_first:n_first + TRAIN_FAIL_AT - TRAIN_CKPT_EVERY]
    first = {h["step"]: h for h in hist[:n_first]}
    if not (res["final_step"] == TRAIN_STEPS and res["restarts"] == 1):
        raise AssertionError(f"14c: final step {res['final_step']}, "
                             f"restarts {res['restarts']}")
    want_steps = (list(range(1, TRAIN_FAIL_AT + 1))
                  + list(range(TRAIN_CKPT_EVERY + 1, TRAIN_STEPS + 1)))
    if [h["step"] for h in hist] != want_steps:
        raise AssertionError(f"14c: logged steps {[h['step'] for h in hist]}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"14c: losses {[h['loss'] for h in hist]}")
    replay_diff = {k: max(abs(h[k] - first[h["step"]][k])
                          / max(abs(first[h["step"]][k]), 1e-30)
                          for h in replay) for k in ("loss", "grad_norm")}
    replay_exact = all(h == first[h["step"]] for h in replay)
    if not replay_exact and max(replay_diff.values()) > REPLAY_TOL:
        raise AssertionError(f"14c: replayed steps {replay} differ from "
                             f"their first pass beyond {REPLAY_TOL}")
    if counts[FK.TC] < 1 or counts[FK.BWD] < 1:
        raise AssertionError(f"14c: K4 launches {counts}")
    n_exec = len(hist)
    want_bwd = n_exec * TRAIN_ACCUM * cfg.num_units
    if (counts[FK.BWD] != want_bwd or counts[FK.TC] != 2 * want_bwd
            or counts[FK.BWD_ROUTES[FK.TC]] != want_bwd):
        raise AssertionError(f"14c: K4 launches {counts}, expected "
                             f"{2 * want_bwd} forward and {want_bwd} "
                             "backward, all on the tensor cores (remat runs "
                             "each forward twice)")
    alone = [s for s, w in steps if not w][1:]     # the first step warms up
    during = [s for s, w in steps if w]
    step_s = statistics.median(alone)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(cfg, "train", TRAIN_SEQ, TRAIN_BATCH)
    out = {"final_step": res["final_step"], "restarts": res["restarts"],
           "losses": [h["loss"] for h in hist], "wall_s": wall,
           "step_s_alone": alone, "step_s_during_save": during,
           "step_s": step_s, "tokens_per_s": tokens / step_s,
           "model_flops": flops, "mfu": flops / step_s / BF16_OPS_PER_S,
           "peak_gb": peak, "state_gb": state_bytes / 1e9,
           "snapshot_s": saves, "write_s": res["last_ckpt"]["wall_s"],
           "restore_s": restores, "replay_exact": replay_exact,
           "replay_rel": replay_diff, "launches": counts, **room}
    log(f"[14c] Trainer.run(): {res['final_step']} steps, "
        f"{res['restarts']} restart, {n_exec} steps run in {wall:.1f} s; "
        f"losses {[round(x, 4) for x in out['losses']]}; replayed steps "
        f"{'bit-equal to' if replay_exact else 'within ' + str(replay_diff) + ' of'}"
        f" their first pass; a step {step_s:.3f} s alone (median of "
        f"{len(alone)}), {[round(s, 3) for s in during]} s during a save; "
        f"{out['tokens_per_s']:.0f} tokens/s, model flops "
        f"{flops / 1e12:.2f} TFLOP a step = {100 * out['mfu']:.1f} % of 989 "
        f"TFLOP/s; peak {peak:.2f} GB; train state {state_bytes / 1e9:.2f} "
        f"GB: snapshot {[round(s, 2) for s in saves]} s, last write "
        f"{out['write_s']:.2f} s, restore {[round(s, 2) for s in restores]} "
        f"s; launches {counts}")
    return out


def phase_train(device) -> dict:
    """14: training on the card (see the module docstring)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.launch.steps import (init_train_state, make_train_step,
                                          to_device as batch_to)
    from repro_torch.storage.datapipe import SyntheticTokens
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.schedules import wsd

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[14] device memory at the start: {start_gb:.2f} GB allocated "
        "(the peak counter is reset for each part)")
    out = {"flash_bwd": check_flash_bwd(device),
           "rglru_bwd": check_rglru_bwd(device)}

    # -- kernel times at 14b's and 14d's shapes -------------------------
    g = torch.Generator(device=device).manual_seed(9)
    cfg = get_arch(TRAIN_ARCH).config
    rg = dataclasses.replace(get_arch("recurrentgemma-9b").config,
                             n_layers=RG_LAYERS)
    hd, kvh, h = cfg.hd, cfg.n_kv_heads, cfg.n_heads
    qwen = [torch.randn(shape, generator=g, device=device).bfloat16()
            for shape in ((1, h, TRAIN_SEQ, hd), (1, kvh, TRAIN_SEQ, hd),
                          (1, kvh, TRAIN_SEQ, hd))]
    out["k4_bwd"] = time_k4_bwd(*qwen, None)
    del qwen
    win = rg.pattern[-1].window
    rgq = [torch.randn(shape, generator=g, device=device).bfloat16()
           for shape in ((1, rg.n_heads, TRAIN_SEQ, rg.hd),
                         (1, rg.n_kv_heads, TRAIN_SEQ, rg.hd),
                         (1, rg.n_kv_heads, TRAIN_SEQ, rg.hd))]
    out["k4_bwd_rg"] = time_k4_bwd(*rgq, win)
    del rgq
    a, x = rglru_inputs(1, TRAIN_SEQ, rg.rglru.d_rnn, torch.float32, 10,
                        device)
    out["k5_bwd"] = time_k5_bwd(a, RK.rglru_scan_kernel(a, x))
    del a, x
    for key in ("k4_bwd", "k4_bwd_rg"):
        t = out[key]
        log(f"[14] K4 backward at q {tuple(t['shape'])} k/v "
            f"{tuple(t['kv_shape'])} bf16, window {t['window']}: "
            f"{t['ms']:.3f} ms ({t['ops'] / t['ms'] / 1e9:.1f} TFLOP/s of "
            f"the kept pairs, {100 * t['bound_ms'] / t['ms']:.1f} % of the "
            f"bound {t['bound_ms']:.4f} ms, {t['bound_by']}), plain "
            f"{t['plain_ms']:.3f} ms, SDPA backward {t['library_ms']} ms "
            f"(its forward {t.get('library_fwd_ms')} ms); K4's forward "
            f"with lse {t['fwd_lse_ms']:.3f} ms; within {t['rel_err']:.2e} "
            "of the plain version")
    t = out["k5_bwd"]
    log(f"[14] K5 backward at {tuple(t['shape'])} f32: {t['ms']:.3f} ms "
        f"(bound {t['bound_ms']:.4f} ms, {t['bound_by']}; the reverse "
        f"{t['route']} launch alone, outputs made beforehand, "
        f"{t['scan_ms']:.3f} ms), plain {t['plain_ms']:.1f} ms")

    # -- 14b: one train step of qwen2-0.5b, kernels against plain --------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, OptConfig(), torch.Generator(
        device=device).manual_seed(LM_SEED), device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = batch_to(next(iter(SyntheticTokens(
        cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=LM_SEED))),
        device)
    out["14b"] = grads_against_plain("14b", cfg, state["params"], batch,
                                     TRAIN_ACCUM)
    step = make_train_step(cfg, OptConfig(), wsd(*TRAIN_WSD),
                           grad_accum=TRAIN_ACCUM)
    reset_kernel_counts()
    mem = CallMemory(state, batch)
    t0 = time.perf_counter()
    new_state, metrics = step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_mem = mem.done()
    counts = kernel_counts()
    del new_state
    want = TRAIN_ACCUM * cfg.num_units
    if (counts[FK.BWD] != want or counts[FK.TC] != 2 * want
            or counts[FK.BWD_ROUTES[FK.TC]] != want):
        raise AssertionError(f"14b: a step launched {counts}")
    out["14b"].update(init_s=init_s, step_s=step_s, step_launches=counts,
                      peak_gb=step_mem["peak_gb"], memory=step_mem,
                      metrics={k: float(v) for k, v in metrics.items()})
    # where a step's device time goes: one more step (on the same state;
    # its result is dropped)
    out["14b"].update(step_split("14b", lambda: step(state, batch), step_s))
    log(f"[14b] {cfg.name}: train state initialised in {init_s:.1f} s; one "
        f"step of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_ACCUM} "
        f"microbatches, remat {cfg.remat}: {step_s:.2f} s (the first); K4 "
        f"{counts[FK.TC]} forward launches (each run again by remat) and "
        f"{counts[FK.BWD]} backward calls a step; metrics "
        f"{out['14b']['metrics']}; peak {out['14b']['peak_gb']:.2f} GB")

    # -- 14c: Trainer.run(), from the same fresh state -------------------
    del state, batch
    torch.cuda.empty_cache()
    out["14c"] = train_run(cfg, device)

    # -- 14d: recurrentgemma-9b at full width, depth cut ----------------
    ocfg = OptConfig(moment_dtype="int8")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(rg, ocfg, torch.Generator(
        device=device).manual_seed(LM_SEED), device=device)
    n_params = sum(x.numel() for x in _leaves(state["params"]))
    it = iter(SyntheticTokens(rg.vocab_size, batch=RG_BATCH, seq=TRAIN_SEQ,
                              seed=LM_SEED + 1))
    batch = batch_to(next(it), device)
    out["14d"] = grads_against_plain("14d", rg, state["params"], batch, 1)
    step = make_train_step(rg, ocfg, wsd(*TRAIN_WSD))
    reset_kernel_counts()
    mem = CallMemory(state, batch)
    t0 = time.perf_counter()
    losses = []
    for i in range(RG_STEPS):
        state, metrics = step(state, batch if i == 0 else
                              batch_to(next(it), device))
        if i == 0:
            step_mem = mem.done()
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    rg_s = time.perf_counter() - t0
    counts = kernel_counts()
    # remat runs a unit's forwards twice; the tail's once
    n_unit = sum(sp.mixer == "rglru" for sp in rg.pattern) * rg.num_units
    n_tail = sum(sp.mixer == "rglru" for sp in rg.tail)
    n_attn = sum(sp.mixer == "attn" for sp in rg.pattern) * rg.num_units
    k5_step = 3 * n_unit + 2 * n_tail
    want = {FK.TC: 2 * n_attn * RG_STEPS, FK.F32: 0,
            FK.BWD: n_attn * RG_STEPS,
            FK.BWD_ROUTES[FK.TC]: n_attn * RG_STEPS, FK.BWD_ROUTES[FK.F32]: 0,
            RK.TOTAL: k5_step * RG_STEPS,
            RK.ROUTE_KEYS["ring"]: k5_step * RG_STEPS,
            RK.ROUTE_KEYS["simple"]: 0, RK.BWD: (n_unit + n_tail) * RG_STEPS}
    if counts != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"14d: launches {counts} (expected {want}), "
                             f"losses {losses}")
    out["14d"].update(n_params=n_params, steps_s=rg_s, losses=losses,
                      step_launches=counts, memory=step_mem,
                      peak_gb=max(step_mem["peak_gb"],
                                  torch.cuda.max_memory_allocated() / 1e9))
    # one more step's kernels (its result dropped), as 14b's
    out["14d"].update(step_split("14d", lambda: step(state, batch),
                                 rg_s / RG_STEPS))
    log(f"[14d] {rg.name} cut to {RG_LAYERS} layers: {n_params / 1e9:.3f} B "
        f"parameters, int8 moments; {RG_STEPS} steps of {RG_BATCH} x "
        f"{TRAIN_SEQ} in {rg_s:.2f} s, losses {losses}; launches {counts} "
        f"(K5 ring: {k5_step} a step, of them {n_unit + n_tail} backward; K4 at "
        f"D = {rg.hd}, window {rg.pattern[-1].window}: {2 * n_attn} forward, "
        f"{n_attn} backward a step); peak {out['14d']['peak_gb']:.2f} GB")
    del state, batch

    out["seconds"] = time.perf_counter() - t_phase
    log(f"[14] phase 14 in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the dry run (``launch.dryrun``) against the card
# ---------------------------------------------------------------------------


def dryrun_cells() -> dict:
    """The four cells of phase 15a as (config, shape, optimizer config,
    grad_accum): the calls phases 8b, 13b, 14b and 14d measure."""
    import dataclasses

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_arch
    from repro_torch.train.optimizer import OptConfig

    wave = ShapeSpec("wave", "prefill", max(LM_PROMPT_LENS),
                     len(LM_PROMPT_LENS))
    rg = get_arch(LM_ARCH).config
    qwen = get_arch(TRAIN_ARCH).config
    return {
        "8b": (rg, wave, OptConfig(), 1),
        "13b": (get_arch("qwen2-0.5b").config, wave, OptConfig(), 1),
        "14b": (qwen, ShapeSpec("step", "train", TRAIN_SEQ, TRAIN_BATCH),
                OptConfig(), TRAIN_ACCUM),
        "14d": (dataclasses.replace(rg, n_layers=RG_LAYERS),
                ShapeSpec("step", "train", TRAIN_SEQ, RG_BATCH),
                OptConfig(moment_dtype="int8"), 1)}


def phase_dryrun(device, measured: dict) -> dict:
    """15: (15a) ``plan_cell`` + the meta run of each cell measured in
    phases 8b, 13b, 14b and 14d on the ``card`` mesh: argument bytes equal
    to the real tensors', the predicted peak within DRYRUN_PEAK_TOL of
    the call's measured rise; (15b) the per-device argument bytes of all
    ten ids' ``train_4k`` on the production meshes (``dryrun.arg_bytes``:
    every sharded dim divides, or the plan raises; the rank plans of
    those cells are the CLI's, hours of meta runs for all ten); (15c)
    ``make_dp_grad_sync`` on a one-rank NCCL group (a ``FileStore`` in a
    temporary directory) over 14b's gradients, bit-equal to the int8
    quantise / dequantise done leaf by leaf in plain torch on the card."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import ARCH_IDS, get_arch
    from repro_torch.distributed.compression import make_dp_grad_sync
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (H100_TOTAL_MEMORY, make_card_mesh,
                                         make_mesh)
    from repro_torch.launch.steps import (init_train_state, loss_and_grads,
                                          plan_cell, to_device as batch_to)
    from repro_torch.storage.datapipe import SyntheticTokens
    from repro_torch.train.optimizer import OptConfig, tree_paths

    t_phase = time.perf_counter()
    mesh = make_card_mesh(device)
    out = {"device_memory": mesh.device_memory, "cells": {}}
    log(f"[15] planning on the card mesh: {mesh.memory_source}, "
        f"total_memory {mesh.device_memory} B (without a card the plans "
        f"take launch.mesh.H100_TOTAL_MEMORY = {H100_TOTAL_MEMORY} B)")

    # -- 15a: predicted against measured --------------------------------
    for label, (cfg, shape, ocfg, accum) in dryrun_cells().items():
        t0 = time.perf_counter()
        plan = plan_cell(cfg, shape, mesh, ocfg=ocfg, grad_accum=accum)
        args = dryrun.arg_bytes(plan, mesh)
        m = dryrun.run_meta(plan, mesh)
        got = measured[label]
        ratio = m.peak_alloc_bytes / got["rise"]
        cell = {"arg_bytes": args["total"],
                "measured_arg_bytes": got["arg_bytes"],
                "predicted_peak": m.peak_alloc_bytes,
                "predicted_peak_raw": m.peak_bytes,
                "measured_rise": got["rise"],
                "instrument_bytes": got["instrument_bytes"],
                "ratio": ratio,
                "fits": args["total"] + m.peak_alloc_bytes
                <= mesh.device_memory,
                "dot_flops": m.dot_flops, "traffic_bytes": m.traffic_bytes,
                "aten_ops": m.ops, "meta_run_s": m.seconds,
                "plan_s": time.perf_counter() - t0}
        out["cells"][label] = cell
        log(f"[15a] {label} {cfg.name} {shape.kind} {shape.global_batch} x "
            f"{shape.seq_len} (grad_accum {accum}, remat {cfg.remat}, "
            f"{ocfg.moment_dtype} moments): arguments {args['total']} B "
            f"planned, {got['arg_bytes']} B on the card; peak predicted "
            f"{m.peak_alloc_bytes / 1e9:.3f} GB, measured rise "
            f"{got['rise'] / 1e9:.3f} GB (less "
            f"{got['instrument_bytes'] / 1e9:.3f} GB of this script's "
            f"clones), predicted / measured {ratio:.4f}; dot flops "
            f"{m.dot_flops / 1e12:.3f} TFLOP, traffic "
            f"{m.traffic_bytes / 1e9:.1f} GB, {m.ops} aten ops, meta run "
            f"{m.seconds:.1f} s")
        if args["total"] != got["arg_bytes"]:
            raise AssertionError(f"15a {label}: planned argument bytes "
                                 f"{args['total']} != {got['arg_bytes']}")
        if abs(ratio - 1.0) > DRYRUN_PEAK_TOL:
            raise AssertionError(f"15a {label}: predicted peak off the "
                                 f"measured rise by {ratio:.4f} (bar "
                                 f"{DRYRUN_PEAK_TOL})")

    # -- 15b: the production meshes -------------------------------------
    t0 = time.perf_counter()
    prod = {}
    for arch in ARCH_IDS:
        a = get_arch(arch)
        for mesh_name in ("single", "multi"):
            prod_mesh = make_mesh(mesh_name)
            prod[f"{arch}/{mesh_name}"] = dryrun.arg_bytes(plan_cell(
                a.config, a.shape("train_4k"), prod_mesh,
                ocfg=dryrun.opt_config_for(a.config)), prod_mesh)
    out["production"] = prod
    out["production_s"] = time.perf_counter() - t0
    llama = "llama4-maverick-400b-a17b"
    for mesh_name in ("single", "multi"):
        a = prod[f"{llama}/{mesh_name}"]
        log(f"[15b] {llama} train_4k on {mesh_name}: per device "
            f"params {a['params'] / 1e9:.3f} GB + optimizer "
            f"{a['opt'] / 1e9:.3f} GB (int8 moments, ZeRO-1) = train "
            f"state {(a['params'] + a['opt']) / 1e9:.3f} GB, batch "
            f"{a['batch'] / 1e6:.3f} MB")
    log(f"[15b] all {len(ARCH_IDS)} ids' train_4k planned on the 16 x 16 "
        f"and 2 x 16 x 16 meshes, every sharded dim dividing, in "
        f"{out['production_s']:.1f} s")

    # -- 15c: the gradient sync on a one-rank NCCL group ----------------
    cfg = get_arch(TRAIN_ARCH).config
    state = init_train_state(cfg, OptConfig(), torch.Generator(
        device=device).manual_seed(LM_SEED), device=device)
    batch = batch_to(next(iter(SyntheticTokens(
        cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=LM_SEED))),
        device)
    _, _, grads = loss_and_grads(cfg, state["params"], batch, TRAIN_ACCUM)
    del state, batch
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(
            "nccl", store=store, rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            res = {}
            for compress in (True, False):
                sync = make_dp_grad_sync(compress=compress)
                sync(grads)                                # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                synced = sync(grads)
                torch.cuda.synchronize()
                res[compress] = (synced, time.perf_counter() - t0)
        finally:
            dist.destroy_process_group()
    n_leaves = unequal = 0
    wire = 0
    for (path, g), (_, s8), (_, s32) in zip(
            tree_paths(grads), tree_paths(res[True][0]),
            tree_paths(res[False][0])):
        g32 = g.to(torch.float32)
        scale = torch.clamp_min(g32.abs().amax(), 1e-20) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        want = (q.to(torch.float32) * scale) / 1.0
        n_leaves += 1
        unequal += not torch.equal(s8, want)
        unequal += not torch.equal(s32, g32 / 1.0)
        wire += q.numel()
    out["sync"] = {"leaves": n_leaves, "unequal": unequal,
                   "int8_elements": wire,
                   "compressed_s": res[True][1], "plain_s": res[False][1]}
    log(f"[15c] make_dp_grad_sync on a one-rank NCCL group over 14b's "
        f"{n_leaves} gradient leaves ({wire / 1e6:.1f} M elements): int8 "
        f"sync {res[True][1] * 1e3:.2f} ms, plain {res[False][1] * 1e3:.2f} "
        f"ms; {'bit-equal' if not unequal else f'{unequal} leaves differ'} "
        "to the quantise / dequantise in plain torch")
    if unequal:
        raise AssertionError(f"15c: {unequal} synced leaves differ from "
                             "their plain quantise / dequantise")
    del grads, res
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[15] phase 15 in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: caller positions and the logit soft cap (K4's EXT kernels)
# ---------------------------------------------------------------------------

#: Gemma 2's published attn_logit_softcapping, set on qwen2-0.5b
POS_SOFTCAP = 50.0
#: document lengths of the packed batches, drawn uniform from LM_SEED
POS_DOC_LENS = (256, 2048)
#: q's scale in 16a: scores of std 8 that reach about +-36, where the cap's
#: tanh is far from linear (unit q keeps them under 6, where 1 - t^2 >
#: 0.98 and a backward without that factor is within the bf16 bar)
POS_Q_SCALE = 8.0


def packed_positions(b: int, s: int, seed: int, device):
    """[b, s] int32: documents of POS_DOC_LENS tokens drawn uniform from
    ``seed`` until s is filled (the last one cut), positions restarting
    at 0 in each; and the documents' lengths."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    lens = []
    for i in range(b):
        j = 0
        while j < s:
            n = int(rng.integers(POS_DOC_LENS[0], POS_DOC_LENS[1] + 1))
            out[i, j:j + n] = np.arange(min(n, s - j))
            lens.append(min(n, s - j))
            j += n
    return torch.as_tensor(out, device=device), lens


def kept_pairs(q_pos, k_pos, causal: bool, window) -> int:
    """(query, key) pairs the positional mask keeps, over the batch: for
    each query the keys at positions (q - window, q] (or <= q)."""
    import torch
    n = 0
    for qp, kp in zip(q_pos.long(), k_pos.long()):
        ks = torch.sort(kp).values
        hi = (torch.searchsorted(ks, qp, right=True) if causal
              else torch.full_like(qp, ks.numel()))
        lo = (torch.searchsorted(ks, qp - window, right=True) if window
              else torch.zeros_like(qp))
        n += int((hi - lo).clamp_min(0).sum())
    return n


def check_k4_ext(q, k, v, do, pos, cap) -> dict:
    """16a on one route: forward (output and lse) and backward of the EXT
    instantiation against the plain versions, the dtype's route and EXT
    counters moving by one each (these comparison launches are not the
    main path's).  The plain backward without the cap's factor 1 - t^2
    (what a kernel that dropped it would give) must lie further from the
    right one than the bar and the kernel's own error together, so that
    the bar fails such a kernel."""
    from unittest import mock

    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_lse_reference,
        attention_reference)
    kw = dict(q_pos=pos, k_pos=pos, softcap=cap)
    name = FK.route(q.dtype)
    fwd, bwd = FK.EXT_KEYS[name], FK.EXT_KEYS[FK.BWD_ROUTES[name]]
    before = dict(FK.EXT_LAUNCHES)
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **kw)
    grads = FK.flash_attention_bwd_bhsd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    if FK.EXT_LAUNCHES != {**before, fwd: before[fwd] + 1,
                           bwd: before[bwd] + 1}:
        raise AssertionError(f"16a {name}: EXT launches {before} -> "
                             f"{FK.EXT_LAUNCHES}")
    want = attention_reference(q, k, v, **kw)
    err = float((o.float() - want.float()).abs().max())
    fwd_rel = flash_err(o, want)
    del want
    lse_rel = rel_max(lse, attention_lse_reference(q, k, **kw))
    want_g = attention_backward_reference(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    bwd_err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(grads, want_g))
    bwd_rel = max(rel_max(x, y) for x, y in zip(grads, want_g))
    del grads
    scores = FR._masked_scores
    with mock.patch.object(FR, "_masked_scores",
                           lambda *a, **k_: scores(*a, **k_)[:2] + (None,)):
        no_factor = attention_backward_reference(q, k, v, o, do, **kw)
    cap_factor_rel = max(rel_max(x, y) for x, y in zip(no_factor, want_g))
    del want_g, no_factor
    out = {"max_abs_err": err, "rel_err": fwd_rel, "lse_rel_err": lse_rel,
           "bwd_max_abs_err": bwd_err, "bwd_rel_err": bwd_rel,
           "no_cap_factor_rel_err": cap_factor_rel}
    tol = str(q.dtype)
    if (fwd_rel > FLASH_TOL[tol] or lse_rel > LSE_TOL
            or bwd_rel > FLASH_BWD_TOL[tol]):
        raise AssertionError(f"16a {name} against the plain versions: {out}"
                             f" (bars {FLASH_TOL[tol]}, {LSE_TOL}, "
                             f"{FLASH_BWD_TOL[tol]})")
    if cap_factor_rel <= FLASH_BWD_TOL[tol] + bwd_rel:
        raise AssertionError(f"16a {name}: a backward without the cap's "
                             f"factor is within {cap_factor_rel:.2e}, which "
                             f"the bar {FLASH_BWD_TOL[tol]} would not fail")
    return out


def plain_band(plan, causal: bool, window) -> "torch.Tensor":
    """The plain PyTorch version of ``flash_pos_band`` on the card: the
    plan's band from its sorted positions by ``torch.searchsorted``, in the
    kernel's layout (``tiles.pos_scratch_ints``; pads 0)."""
    import torch
    from repro_torch.kernels.flash_attention import tiles
    rows = []
    for i in range(plan.b):
        qs = plan.q_sorted[min(i, plan.q_sorted.shape[0] - 1)].long()
        ks = plan.k_sorted[min(i, plan.k_sorted.shape[0] - 1)].long()
        sq, sk = qs.numel(), ks.numel()
        lo, hi, qlo, qhi, keyless = tiles.band_of_sorted(
            qs, ks, causal=causal, window=window)
        keyless = torch.nonzero(keyless).flatten()
        # the kernel keeps the hull as sq - first, last + 1 (0, 0: none)
        hull = (torch.stack([sq - keyless.min(), keyless.max() + 1])
                if keyless.numel() else torch.zeros(2, dtype=torch.int64,
                                                    device=qs.device))
        pad = [lambda x, n=n: torch.nn.functional.pad(x, (0, n - x.numel()))
               for n in (tiles.pos_pad(sq), tiles.pos_pad(sk))]
        rows.append(torch.cat([pad[0](lo), pad[0](hi), pad[1](qlo),
                               pad[1](qhi), hull, hull.new_zeros(2)]))
    return torch.cat(rows).int()


def old_rule_tiles(pos, bq: int, bk: int) -> int:
    """Tiles PR 25's positional rule visited on one row of positions
    (causal, no window): a (query tile, key tile) pair unless every key
    lies after every query (min k_pos > max q_pos), in index order."""
    import torch
    p = pos.long()
    s = p.numel()

    def spans(n):
        t = torch.nn.functional.pad(p, (0, -s % n), value=p.max())
        return t.view(-1, n).amin(1), torch.nn.functional.pad(
            p, (0, -s % n), value=p.min()).view(-1, n).amax(1)
    _, q_max = spans(bq)
    k_min, _ = spans(bk)
    return int((k_min[None, :] <= q_max[:, None]).sum())


def check_k4_prepasses(q, k, v, pos) -> dict:
    """16a: the EXT path's pre-passes against their plain versions on the
    card, the band (``flash_pos_band``) equal to ``plain_band``, the sorted
    copies (``flash_pos_gather``) equal to ``index_select``; each timed on
    the device (``queued_ms``: the host's work hidden; the band made
    afresh, its zeroing included), with its bound: the band reads the
    sorted positions and writes the band (its binary searches are a few
    compares a row), the gather reads and writes q, k and v once; the
    plan's sort (``torch.sort``) beside."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.plan import PosPlan
    plan = PosPlan.build(pos)
    band = FK.pos_band(plan, True, None)
    want = plain_band(plan, True, None)
    sorted_ = FK.gather_sorted(plan, q, k, v)
    perm = plan.q_perm[0].long()
    plain = [x.index_select(2, perm) for x in (q, k, v)]
    torch.cuda.synchronize()
    band_err = int((band - want).abs().max())
    gather_err = max(float((x.float() - y.float()).abs().max())
                     for x, y in zip(sorted_, plain))
    if band_err != 0 or gather_err != 0.0:
        raise AssertionError(f"16a pre-passes against their plain versions: "
                             f"band {band_err}, gather {gather_err}")

    def fresh_band():
        plan.bands.clear()
        FK.pos_band(plan, True, None)
    out = {"band_max_abs_err": band_err, "gather_max_abs_err": gather_err,
           "sort_ms": queued_ms(lambda: PosPlan.build(pos)),
           "band_ms": queued_ms(fresh_band),
           "band_plain_ms": queued_ms(lambda: plain_band(plan, True, None)),
           "gather_ms": queued_ms(lambda: FK.gather_sorted(plan, q, k, v)),
           "gather_plain_ms": queued_ms(lambda: [
               x.index_select(2, perm) for x in (q, k, v)])}
    n = pos.numel()
    band_bytes = 2 * n * 4 + band.numel() * 4
    out["band_bound_ms"], out["band_bound_by"] = bound_ms(
        band_bytes, 4.0 * n * math.log2(max(n, 2)))
    gather_bytes = 2 * sum(x.numel() * x.element_size() for x in (q, k, v))
    out["gather_bound_ms"], out["gather_bound_by"] = bound_ms(gather_bytes,
                                                              0.0)
    return out


def time_k4_ext(q, k, v, do, pos, cap) -> dict:
    """16a's times at the slice's shape (bf16): the EXT forward (without
    and with lse) and backward on the positions' plan, made once as a
    model forward makes it (so a call is the sorted copies and the
    kernels), and the forward from the positions alone (the plan made in
    the call), each one call between CUDA events (median of 3), their
    plain versions, the index path on the same q, k, v (causal on arange,
    no cap), the cap alone on ``arange`` (the identity plan: the index
    band with the cap), SDPA with the positions' boolean mask (kv heads
    repeated; no cap: no PyTorch call computes it), forward and forward +
    backward - forward; the same on the device alone (``queued_ms``, the
    host's work of a call hidden: ``*_device_ms``); the tiles each
    schedule visits (the tensor-core forward's and dk/dv blocks'; PR 25's
    positional rule beside); the bounds from the kept pairs: 4 D flops a
    pair forward, 10 D backward, each input read and output written
    once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import tiles
    from repro_torch.kernels.flash_attention.plan import PosPlan
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_reference)
    kw = dict(q_pos=pos, k_pos=pos, softcap=cap)
    b, h, s, d = q.shape
    plan = PosPlan.build(pos)
    pk = dict(plan=plan, softcap=cap)
    ident = PosPlan.identity(b, s, s, 0, q.device)
    o, lse = FK.flash_attention_bhsd(q, k, v, with_lse=True, **pk)
    t = {"shape": list(q.shape), "kv_shape": list(k.shape), "softcap": cap,
         "ms": cuda_ms(lambda: FK.flash_attention_bhsd(q, k, v, **pk)),
         "fwd_lse_ms": cuda_ms(lambda: FK.flash_attention_bhsd(
             q, k, v, with_lse=True, **pk)),
         "from_positions_ms": cuda_ms(lambda: FK.flash_attention_bhsd(
             q, k, v, **kw)),
         "bwd_ms": cuda_ms(lambda: FK.flash_attention_bwd_bhsd(
             q, k, v, o, do, lse, **pk)),
         "index_path_ms": cuda_ms(lambda: FK.flash_attention_bhsd(q, k, v)),
         "cap_alone_ms": cuda_ms(lambda: FK.flash_attention_bhsd(
             q, k, v, plan=ident, softcap=cap)),
         "index_path_bwd_ms": None,
         "plain_ms": cuda_ms(lambda: attention_reference(q, k, v, **kw),
                             warmup=False),
         "bwd_plain_ms": cuda_ms(lambda: attention_backward_reference(
             q, k, v, o, do, **kw), warmup=False)}
    io, ilse = FK.flash_attention_bhsd(q, k, v, with_lse=True)
    t["index_path_bwd_ms"] = cuda_ms(lambda: FK.flash_attention_bwd_bhsd(
        q, k, v, io, do, ilse))
    t["cap_alone_bwd_ms"] = cuda_ms(lambda: FK.flash_attention_bwd_bhsd(
        q, k, v, io, do, ilse, plan=ident, softcap=cap))
    t["device"] = {
        "ms": queued_ms(lambda: FK.flash_attention_bhsd(q, k, v, **pk)),
        "bwd_ms": queued_ms(lambda: FK.flash_attention_bwd_bhsd(
            q, k, v, o, do, lse, **pk)),
        "index_path_ms": queued_ms(lambda: FK.flash_attention_bhsd(q, k, v)),
        "index_path_bwd_ms": queued_ms(lambda: FK.flash_attention_bwd_bhsd(
            q, k, v, io, do, ilse)),
        "cap_alone_ms": queued_ms(lambda: FK.flash_attention_bhsd(
            q, k, v, plan=ident, softcap=cap)),
        "cap_alone_bwd_ms": queued_ms(lambda: FK.flash_attention_bwd_bhsd(
            q, k, v, io, do, ilse, plan=ident, softcap=cap)),
        "positions_no_cap_ms": queued_ms(lambda: FK.flash_attention_bhsd(
            q, k, v, plan=plan))}
    po, plse = FK.flash_attention_bhsd(q, k, v, with_lse=True, plan=plan)
    t["device"]["positions_no_cap_bwd_ms"] = queued_ms(
        lambda: FK.flash_attention_bwd_bhsd(q, k, v, po, do, plse, plan=plan))
    del io, ilse, po, plse
    (bq, bk), (bk2, bq2) = tiles.tc_tile(d), tiles.BWD_KV_TILE
    band = tiles.pos_band(pos[0].cpu(), pos[0].cpu(), causal=True,
                          window=None)
    t["tiles"] = {
        "fwd": sum(len(r) for r in tiles.pos_schedule(band, bq=bq, bk=bk)),
        "fwd_pr25": old_rule_tiles(pos[0], bq, bk),
        "fwd_index": sum(len(r) for r in tiles.schedule(
            sq=s, sk=s, causal=True, window=None, q_offset=0, bq=bq, bk=bk)),
        "dkdv": sum(len(r) for r in tiles.pos_dkdv_schedule(band, bk=bk2,
                                                            bq=bq2)),
        "dkdv_pr25": old_rule_tiles(pos[0], bq2, bk2),
        "dkdv_index": sum(len(r) for r in tiles.dkdv_schedule(
            sq=s, causal=True, window=None, bk=bk2, bq=bq2))}
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    of, lsef = FK.flash_attention_bhsd(qf, kf, vf, with_lse=True, **pk)
    t["f32_route_ms"] = cuda_ms(lambda: FK.flash_attention_bhsd(
        qf, kf, vf, **pk))
    t["f32_route_bwd_ms"] = cuda_ms(lambda: FK.flash_attention_bwd_bhsd(
        qf, kf, vf, of, dof, lsef, **pk))
    del qf, kf, vf, dof, of, lsef
    group = h // k.shape[1]
    xs = [x.detach().requires_grad_(True) for x in (
        q, k.repeat_interleave(group, dim=1), v.repeat_interleave(group, 1))]
    mask = pos[:, None, :, None] >= pos[:, None, None, :]
    t["library_ms"] = t["library_bwd_ms"] = None
    try:             # the yardstick only, never the path
        t["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            *xs, attn_mask=mask))
        both = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*xs, attn_mask=mask), xs, do))
        t["library_bwd_ms"] = both - t["library_ms"]
        t["device"]["library_ms"] = queued_ms(
            lambda: F.scaled_dot_product_attention(*xs, attn_mask=mask))
        t["device"]["library_bwd_ms"] = queued_ms(
            lambda: torch.autograd.grad(F.scaled_dot_product_attention(
                *xs, attn_mask=mask), xs, do)) - t["device"]["library_ms"]
    except RuntimeError as exc:
        log(f"SDPA mask yardstick failed: {exc}")
    del xs, mask
    t["pairs"] = kept_pairs(pos, pos, True, None)
    t["causal_pairs"] = b * s * (s + 1) // 2
    pos_bytes = 2 * pos.numel() * 4
    t["bytes"] = sum(x.numel() * x.element_size()
                     for x in (q, k, v, o)) + pos_bytes
    t["ops"] = 4.0 * d * t["pairs"] * h
    t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["ops"],
                                            ops_per_s=BF16_OPS_PER_S)
    t["bwd_bytes"] = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + lse.numel() * 4 + pos_bytes
    t["bwd_ops"] = 10.0 * d * t["pairs"] * h
    t["bwd_bound_ms"], t["bwd_bound_by"] = bound_ms(
        t["bwd_bytes"], t["bwd_ops"], ops_per_s=BF16_OPS_PER_S)
    return t


def phase_positions(device) -> dict:
    """16: caller positions and the logit soft cap (see the module
    docstring)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.steps import (init_train_state, make_train_step,
                                          to_device as batch_to)
    from repro_torch.models import transformer
    from repro_torch.storage.datapipe import SyntheticTokens
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.schedules import wsd

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).config,
                              attn_softcap=POS_SOFTCAP)
    out = {"softcap": POS_SOFTCAP, "doc_lens": list(POS_DOC_LENS)}

    # -- 16a: the EXT kernels at the slice's shape, both routes -----------
    g = torch.Generator(device=device).manual_seed(16)
    hd, kvh, h = cfg.hd, cfg.n_kv_heads, cfg.n_heads
    q, k, v, do = (torch.randn(shape, generator=g, device=device).bfloat16()
                   for shape in ((1, h, TRAIN_SEQ, hd), (1, kvh, TRAIN_SEQ, hd),
                                 (1, kvh, TRAIN_SEQ, hd), (1, h, TRAIN_SEQ, hd)))
    q = q * POS_Q_SCALE
    pos, lens = packed_positions(1, TRAIN_SEQ, LM_SEED, device)
    out["16a"] = {"tc": check_k4_ext(q, k, v, do, pos, POS_SOFTCAP),
                  "f32": check_k4_ext(q.float(), k.float(), v.float(),
                                      do.float(), pos, POS_SOFTCAP),
                  "doc_lens": lens}
    out["prepasses"] = check_k4_prepasses(q, k, v, pos)
    out["k4_ext"] = time_k4_ext(q, k, v, do, pos, POS_SOFTCAP)
    del q, k, v, do
    t, pp, tl = out["k4_ext"], out["prepasses"], out["k4_ext"]["tiles"]
    for route, r in (("tc", out["16a"]["tc"]), ("f32", out["16a"]["f32"])):
        log(f"[16a] K4 EXT ({route}) at q {tuple(t['shape'])} k/v "
            f"{tuple(t['kv_shape'])}, packed documents {lens}, cap "
            f"{POS_SOFTCAP}: forward within {r['rel_err']:.2e} (bar "
            f"{FLASH_TOL['torch.bfloat16' if route == 'tc' else 'torch.float32']}"
            f"), lse within {r['lse_rel_err']:.2e}, dq/dk/dv within "
            f"{r['bwd_rel_err']:.2e} of the plain versions (without the "
            f"cap's factor 1 - t^2: {r['no_cap_factor_rel_err']:.2e})")
    log(f"[16a] K4 EXT bf16 times on the positions' plan: forward "
        f"{t['ms']:.3f} ms (with lse {t['fwd_lse_ms']:.3f}; from the "
        f"positions alone, the plan made in the call, "
        f"{t['from_positions_ms']:.3f}; bound {t['bound_ms']:.4f} ms, "
        f"{t['bound_by']}, {t['pairs']} kept pairs of {t['causal_pairs']} "
        f"index-causal ones; {100 * t['bound_ms'] / t['ms']:.1f} % of it), "
        f"backward {t['bwd_ms']:.3f} ms (bound {t['bwd_bound_ms']:.4f} ms, "
        f"{t['bwd_bound_by']}); the index path on the same inputs "
        f"{t['index_path_ms']:.3f} / {t['index_path_bwd_ms']:.3f} ms; the "
        f"cap alone on arange (the index band) {t['cap_alone_ms']:.3f} / "
        f"{t['cap_alone_bwd_ms']:.3f} ms; plain "
        f"{t['plain_ms']:.3f} / {t['bwd_plain_ms']:.3f} ms; CUDA-core route "
        f"on f32 copies {t['f32_route_ms']:.3f} / {t['f32_route_bwd_ms']:.3f}"
        f" ms; SDPA with the positions' mask (no cap) {t['library_ms']} / "
        f"{t['library_bwd_ms']} ms")
    dv_ = t["device"]
    log(f"[16a] the same on the device alone (queued calls): EXT forward "
        f"{dv_['ms']:.4f} / backward {dv_['bwd_ms']:.4f} ms; positions "
        f"without the cap {dv_['positions_no_cap_ms']:.4f} / "
        f"{dv_['positions_no_cap_bwd_ms']:.4f}; the cap alone "
        f"{dv_['cap_alone_ms']:.4f} / {dv_['cap_alone_bwd_ms']:.4f}; the "
        f"index path {dv_['index_path_ms']:.4f} / "
        f"{dv_['index_path_bwd_ms']:.4f}; SDPA with the mask "
        f"{dv_.get('library_ms')} / {dv_.get('library_bwd_ms')} ms")
    log(f"[16a] tiles visited, forward blocks: {tl['fwd']} sorted "
        f"({tl['fwd'] / tl['fwd_index']:.4f}x the index path's "
        f"{tl['fwd_index']}; PR 25's rule {tl['fwd_pr25']}); dk/dv blocks: "
        f"{tl['dkdv']} ({tl['dkdv'] / tl['dkdv_index']:.4f}x of "
        f"{tl['dkdv_index']}; PR 25's {tl['dkdv_pr25']})")
    log(f"[16a] pre-passes: the plan's sort {pp['sort_ms']:.4f} ms; "
        f"flash_pos_band {pp['band_ms']:.4f} ms (plain {pp['band_plain_ms']:.4f}"
        f", bound {pp['band_bound_ms']:.5f}, {pp['band_bound_by']}), equal to "
        f"its plain version; flash_pos_gather {pp['gather_ms']:.4f} ms "
        f"(index_select {pp['gather_plain_ms']:.4f}, bound "
        f"{pp['gather_bound_ms']:.5f}, {pp['gather_bound_by']}), equal")
    if tl["fwd"] > 1.05 * tl["fwd_index"] or \
            tl["dkdv"] > 1.05 * tl["dkdv_index"]:
        raise AssertionError(f"16a: the sorted schedules visit {tl}, more "
                             "than 1.05x the index path's tiles")

    # -- 16b: the packed, soft-capped qwen2-0.5b step and scoring --------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, OptConfig(), torch.Generator(
        device=device).manual_seed(LM_SEED), device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = batch_to(next(iter(SyntheticTokens(
        cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=LM_SEED + 16))),
        device)
    batch["positions"], blens = packed_positions(TRAIN_BATCH, TRAIN_SEQ,
                                                 LM_SEED + 1, device)
    out["16b"] = grads_against_plain("16b", cfg, state["params"], batch,
                                     TRAIN_ACCUM)
    step = make_train_step(cfg, OptConfig(), wsd(*TRAIN_WSD),
                           grad_accum=TRAIN_ACCUM)
    reset_kernel_counts()
    t0 = time.perf_counter()
    new_state, metrics = step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_counts, step_ext = kernel_counts(), dict(FK.EXT_LAUNCHES)
    step_prep = dict(FK.PREP_LAUNCHES)
    del new_state
    want = TRAIN_ACCUM * cfg.num_units
    tc_fwd, tc_bwd = FK.EXT_KEYS[FK.TC], FK.EXT_KEYS[FK.BWD_ROUTES[FK.TC]]
    if (step_counts[FK.TC] != 2 * want or step_counts[FK.F32] != 0
            or step_counts[FK.BWD_ROUTES[FK.TC]] != want
            or step_ext != {**{k_: 0 for k_ in step_ext},
                            tc_fwd: 2 * want, tc_bwd: want}):
        raise AssertionError(f"16b: a step launched {step_counts}, EXT "
                             f"{step_ext}: expected {2 * want} forward and "
                             f"{want} backward EXT launches, all on the "
                             "tensor cores")
    # one plan a forward (a microbatch; remat replays reuse it), so one
    # band pre-pass each; sorted copies for every EXT call
    if step_prep != {FK.BAND: TRAIN_ACCUM, FK.GATHER: 3 * want}:
        raise AssertionError(f"16b: a step ran the pre-passes {step_prep}: "
                             f"expected {TRAIN_ACCUM} band pre-passes (one a "
                             f"forward) and {3 * want} gathers")
    # one scoring forward (no gradient) of the first row, then the same
    # with the plain attention
    inputs, spos = batch["inputs"][:1], batch["positions"][:1]
    reset_kernel_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = transformer.forward(cfg, state["params"], inputs, spos,
                                        mode="eval")
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        score_counts, score_ext = kernel_counts(), dict(FK.EXT_LAUNCHES)
        score_prep = dict(FK.PREP_LAUNCHES)
        with plain_kernels():
            plain_logits, _ = transformer.forward(
                cfg, state["params"], inputs, spos, mode="eval")
    torch.cuda.synchronize()
    if (score_counts[FK.TC] != cfg.num_units or score_counts[FK.F32] != 0
            or score_ext[tc_fwd] != cfg.num_units
            or score_counts[FK.BWD] != 0
            or score_prep != {FK.BAND: 1, FK.GATHER: cfg.num_units}):
        raise AssertionError(f"16b scoring: launches {score_counts}, EXT "
                             f"{score_ext}, pre-passes {score_prep}")
    if not (tuple(logits.shape[:2]) == (1, TRAIN_SEQ)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"16b scoring: logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    # the scores' next-token cross entropy against the plain attention's
    # (the step's loss bar); the logits' largest difference and the
    # argmax agreement reported beside
    labels = batch["labels"][:1].long()
    ce, plain_ce = (float((torch.logsumexp(x, -1) - torch.gather(
        x, -1, labels[..., None])[..., 0]).mean())
        for x in (logits, plain_logits))
    vocab = cfg.vocab_size      # the padded columns hold -1e30
    score_rel = flash_err(logits[..., :vocab], plain_logits[..., :vocab])
    agree = float((logits.argmax(-1) == plain_logits.argmax(-1)).float()
                  .mean())
    del logits, plain_logits
    ce_rel = abs(ce - plain_ce) / abs(plain_ce)
    if ce_rel > TRAIN_LOSS_TOL:
        raise AssertionError(f"16b scoring: cross entropy {ce} against the "
                             f"plain attention's {plain_ce} ({ce_rel:.2e}, "
                             f"bar {TRAIN_LOSS_TOL})")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, batch
    torch.cuda.empty_cache()
    out["16b"].update(
        init_s=init_s, step_s=step_s, step_launches=step_counts,
        step_ext_launches=step_ext, step_prep_launches=step_prep,
        score_prep_launches=score_prep, doc_lens=blens,
        metrics={k_: float(v_) for k_, v_ in metrics.items()},
        score_s=score_s, score_launches=score_counts,
        score_ext_launches=score_ext, score_ce=ce, score_plain_ce=plain_ce,
        score_ce_rel=ce_rel, score_rel_err=score_rel,
        score_argmax_agree=agree, peak_gb=peak,
        ext_launches=step_ext[tc_fwd] + score_ext[tc_fwd])
    log(f"[16b] {cfg.name} with attn_softcap {POS_SOFTCAP}, full width and "
        f"depth ({cfg.n_layers} layers), {TRAIN_BATCH} x {TRAIN_SEQ} packed "
        f"tokens (documents {blens}) in {TRAIN_ACCUM} microbatches, remat "
        f"{cfg.remat}: one step {step_s:.2f} s (the first), K4 EXT "
        f"{step_ext[tc_fwd]} forward and {step_ext[tc_bwd]} backward "
        f"launches, all tensor-core, pre-passes {step_prep}; metrics "
        f"{out['16b']['metrics']}; scoring forward of 1 x {TRAIN_SEQ} "
        f"{score_s:.2f} s ({score_ext[tc_fwd]} EXT launches, pre-passes "
        f"{score_prep}): cross entropy {ce:.6f} against the plain "
        f"attention's {plain_ce:.6f} ({ce_rel:.2e}, bar {TRAIN_LOSS_TOL}), "
        f"logits within {score_rel:.2e} of the largest, argmax agreeing on "
        f"{100 * agree:.2f} % of positions; peak {peak:.2f} GB; state "
        f"initialised in {init_s:.1f} s")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[16] phase 16 in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the multi-device paths (sweeps on a points mesh, the Trainer on
# a data-parallel mesh with ZeRO-1)
# ---------------------------------------------------------------------------

#: 17a: the points mesh is MULTI_SHARDS shards of cuda:0 (and every card
#: where the host has two or more); phase 5's 64-point sweep on prefix,
#: phase 10b's 30 write points on scan and squaring, a fleet of
#: MULTI_FLEET[0] traces of MULTI_FLEET[1]-MULTI_FLEET[2] ops on 8 x 16 on
#: scan, and an aged sweep of the points MULTI_FTL_OPS at phase 11a's spec
#: over the first MULTI_FTL_REQUESTS requests of its stream
MULTI_SHARDS = 2
MULTI_FLEET = (5, 1000, 2000)
MULTI_FTL_OPS = (0.2, 0.3)
MULTI_FTL_REQUESTS = 1024
#: 17b: Trainer steps on phase 14's batches, mesh-less and on a one-rank
#: NCCL mesh with ZeRO-1
MULTI_STEPS = 3
#: 17c: two gloo ranks sharing cuda:0, each case (arch, grad_accum, moment
#: dtype) at SMOKE size and f32 compute for MULTI_SMOKE_STEPS steps of
#: MULTI_SMOKE_BATCH x MULTI_SMOKE_SEQ tokens with ragged masks, held to
#: the bars of tests/test_torch_train_step.py: metrics 1e-5 relative,
#: updates 1e-3 of the leaf's largest (1/127 with int8 moments), moments
#: 1e-4 of the leaf's largest (int8 codes one step)
MULTI_RANKS = 2
MULTI_TIMEOUT_S = 300
MULTI_SMOKES = (("qwen2-0.5b", 2, "f32"), ("recurrentgemma-9b", 1, "int8"))
MULTI_SMOKE_BATCH, MULTI_SMOKE_SEQ, MULTI_SMOKE_STEPS = 4, 64, 2
MULTI_METRIC_TOL, MULTI_UPDATE_TOL, MULTI_MOMENT_TOL = 1e-5, 1e-3, 1e-4


class ShardCounter:
    """Counts the blocks each sharded call runs, by device, through
    ``core.api._shard_points``."""

    def __init__(self):
        from repro_torch.core import api as core_api
        self.api, self.real = core_api, core_api._shard_points
        self.blocks: list = []

        def counted(mesh, fn, *, n_sharded):
            def block(*args, device):
                self.blocks.append(str(device))
                return fn(*args, device=device)
            return self.real(mesh, block, n_sharded=n_sharded)
        core_api._shard_points = counted

    def take(self) -> list:
        out, self.blocks = self.blocks, []
        return out

    def restore(self) -> None:
        self.api._shard_points = self.real


def multi_sweeps(device, mesh, trace, tables) -> dict:
    """17a on one points mesh: each call sharded (every block counted on
    its device) and with ``shard=False``, bit-equal, both walls."""
    import dataclasses

    import numpy as np
    from repro_torch import api
    from repro_torch.core import calibrate, ftl
    from repro_torch.core.interface import InterfaceKind, make_interface
    from repro_torch.core.nand import CellType, chip as nand_chip
    from repro_torch.core.paper_tables import INTERFACE_ORDER
    from repro_torch.core.sim import SSDConfig, page_op_params
    from repro_torch.core.trace import mixed_trace
    from repro_torch.core.workload import overwrite_stream

    cells = [(c, k, w) for c in ("slc", "mlc") for k in INTERFACE_ORDER
             for w in (1, 2, 4, 8, 16)]
    ops = [page_op_params(make_interface(InterfaceKind(k)),
                          nand_chip(CellType(c)), "write", w)
           for c, k, w in cells]
    cols = [np.asarray([float(getattr(op, f)) for op in ops])
            for f in calibrate._OP_FIELDS]
    ways = np.asarray([w for *_, w in cells], np.int32)
    n, lo, hi = MULTI_FLEET
    lengths = np.linspace(lo, hi, n).astype(int)
    fleet = [mixed_trace(int(t), SWEEP_CHANNELS, SWEEP_WAYS, 0.7, seed=70 + i)
             for i, t in enumerate(lengths)]
    cfg = SSDConfig(interface=InterfaceKind.PROPOSED, cell=CellType.SLC,
                    channels=SWEEP_CHANNELS, ways=SWEEP_WAYS)
    specs = [ftl.FTLSpec(blocks=FTL_BLOCKS, pages_per_block=FTL_PPB,
                         overprovision=op, precondition=True)
             for op in MULTI_FTL_OPS]
    whole = overwrite_stream(FTL_REQUESTS, int(0.9 * specs[-1].logical_pages),
                             read_fraction=FTL_READ_FRACTION, seed=FTL_SEED)
    stream = dataclasses.replace(whole, **{
        f: getattr(whole, f)[:MULTI_FTL_REQUESTS]
        for f in ("arrival_us", "op_cls", "n_pages", "stream", "lpn")})
    calls = {
        "sweep_tables(prefix)": lambda shard: api.sweep_tables(
            tables, trace, engine="prefix", shard=shard, device=device),
        "sweep_steady(scan)": lambda shard: api.sweep_steady_bandwidth_mb_s(
            *cols, ways, engine="scan", shard=shard, device=device),
        "sweep_steady(squaring)": lambda shard:
            api.sweep_steady_bandwidth_mb_s(*cols, ways, engine="squaring",
                                            shard=shard, device=device),
        "run_many(scan)": lambda shard: np.asarray([
            r.end_us for r in api.Simulator(cfg, device=device).run_many(
                fleet, engine="scan", shard=shard)]),
        "sweep(ftl=)": lambda shard: api.Simulator(
            cfg, device=device).sweep(None, stream, ftl=specs, shard=shard),
    }
    out = {}
    counter = ShardCounter()
    try:
        with api.points_mesh(mesh):
            for label, call in calls.items():
                one_s, want = timed(lambda: call(False))
                if counter.take():
                    raise AssertionError(f"17a {label}: shard=False sharded")
                shard_s, got = timed(lambda: call(None))
                # one block a device for each sharded fold (run_many: one
                # fold a length bucket)
                blocks = counter.take()
                folds = len(blocks) // mesh.size
                if not blocks or sorted(blocks) != sorted(
                        str(d) for d in mesh.devices * folds):
                    raise AssertionError(f"17a {label}: blocks ran on "
                                         f"{blocks}, mesh {mesh.devices}")
                if not (got.shape == want.shape and np.array_equal(got, want)):
                    raise AssertionError(
                        f"17a {label}: sharded != shard=False (max abs "
                        f"{float(np.max(np.abs(got - want)))})")
                out[label] = {"points": int(got.shape[0]), "folds": folds,
                              "sharded_s": shard_s, "one_device_s": one_s}
    finally:
        counter.restore()
    return out


class SmokeBatches:
    """MULTI_SMOKE_STEPS seeded batches with ragged masks (row 0 two
    tokens, row 1 all, row 2 none, row 3 about 70 %) as a resumable
    pipeline."""

    def __init__(self, vocab: int):
        import numpy as np
        self.items, self.cursor = [], 0
        b, s = MULTI_SMOKE_BATCH, MULTI_SMOKE_SEQ
        for i in range(MULTI_SMOKE_STEPS):
            rng = np.random.default_rng(40 + i)
            mask = np.zeros((b, s), np.float32)
            mask[0, :2] = 1.0
            mask[1] = 1.0
            mask[3] = rng.random(s) < 0.7
            self.items.append({
                "inputs": rng.integers(0, vocab, (b, s)).astype(np.int32),
                "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
                "mask": mask})

    def state(self):
        from repro_torch.storage.datapipe import PipeState
        return PipeState(self.cursor)

    def restore(self, st) -> None:
        self.cursor = st.cursor

    def __iter__(self):
        import torch
        while True:
            b = self.items[self.cursor % len(self.items)]
            self.cursor += 1
            yield {k: torch.tensor(v) for k, v in b.items()}


def smoke_trainer(arch, accum, moments, ckpt_dir, device=None, mesh=None):
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_arch(arch).smoke, compute_dtype="f32")
    return Trainer(cfg, TrainerConfig(
        steps=MULTI_SMOKE_STEPS, log_every=1, ckpt_every=MULTI_SMOKE_STEPS,
        ckpt_dir=str(ckpt_dir), grad_accum=accum, zero1=True),
        SmokeBatches(cfg.vocab_size), ocfg=OptConfig(moment_dtype=moments),
        device=device, mesh=mesh)


def multi_rank(rank: int, tmp: str) -> None:
    """17c: one of MULTI_RANKS gloo ranks sharing cuda:0 (a spawned
    process): every SMOKE case through the data-parallel Trainer, its
    launches counted; rank 0 writes the histories and gathered states."""
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.storage.checkpoint import gather_from_mesh
    from repro_torch.train.optimizer import tree_paths

    # a collective that waits longer than MULTI_TIMEOUT_S raises, so a
    # rank that dies cannot hold its peer past the script's limit
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), MULTI_RANKS), rank=rank,
        world_size=MULTI_RANKS,
        timeout=datetime.timedelta(seconds=MULTI_TIMEOUT_S))
    try:
        mesh = make_data_mesh(device="cuda:0")
        out = {}
        for arch, accum, moments in MULTI_SMOKES:
            tr = smoke_trainer(arch, accum, moments,
                               os.path.join(tmp, arch), mesh=mesh)
            reset_kernel_counts()
            res = tr.run()
            counts = kernel_counts()
            whole = gather_from_mesh(tr.state, tr.state_shardings)
            out[arch] = {"history": res["history"], "launches": counts,
                         "restarts": res["restarts"],
                         "state": {"/".join(p): x.cpu() for p, x in
                                   tree_paths(whole)}}
        if rank == 0:
            torch.save(out, os.path.join(tmp, "ranks.pt"))
    finally:
        dist.destroy_process_group()


def updates_close(start, got, want, grad, rel, noise,
                  label: str = "17c") -> float:
    """The largest error of the update ``got - start`` against ``want -
    start`` over the elements whose gradient is above 1e-3 of the leaf's
    largest, relative to the leaf's largest such update; raises where an
    element with a smaller gradient moved more than ``noise`` apart or the
    relative error passes ``rel``."""
    worst = 0.0
    for path in start:
        dg, dw = got[path] - start[path], want[path] - start[path]
        gr = grad[path].abs()
        big = gr > 1e-3 * gr.max()
        if bool(big.any()):
            err = float((dg - dw).abs()[big].max()
                        / max(float(dw.abs()[big].max()), 1e-30))
            worst = max(worst, err)
            if err > rel:
                raise AssertionError(f"{label} {path}: update {err:.2e} > "
                                     f"{rel}")
        small = (dg - dw).abs()[~big]
        if small.numel() and float(small.max()) > noise:
            raise AssertionError(f"{label} {path}: noise update "
                                 f"{float(small.max()):.2e} > {noise}")
    return worst


def multi_two_ranks(device) -> dict:
    """17c: MULTI_RANKS gloo ranks sharing the card against the mesh-less
    Trainer on the card, case by case."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(multi_rank, args=(tmp,), nprocs=MULTI_RANKS,
                           join=True, start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = torch.load(os.path.join(tmp, "ranks.pt"))
        for arch, accum, moments in MULTI_SMOKES:
            out[arch] = smoke_against_meshless("17c", arch, accum, moments,
                                               ranks[arch], device)
        out["spawn_s"] = spawn_s
    return out


def smoke_against_meshless(label, arch, accum, moments, got, device) -> dict:
    """A SMOKE case's multi-rank run (``got``: rank 0's history, gathered
    state and launches) against the mesh-less Trainer on the card from the
    same fresh state: metrics within MULTI_METRIC_TOL, tokens exact, the
    parameters' and masters' updates by ``updates_close`` and the moments
    leaf by leaf (17c's bars)."""
    import tempfile

    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.train.optimizer import tree_paths

    with tempfile.TemporaryDirectory() as tmp:
        tr = smoke_trainer(arch, accum, moments, tmp, device=device)
        start = tr._fresh_state()
        first = next(iter(SmokeBatches(tr.cfg.vocab_size)))
        _, _, grad = loss_and_grads(tr.cfg, start["params"], {
            k: v.to(device) for k, v in first.items()}, accum)
        res = tr.run()
    lr_sum = sum(h["lr"] for h in res["history"])
    for h, w in zip(got["history"], res["history"]):
        for k in ("loss", "ce", "grad_norm", "lr", "moe_aux"):
            if abs(h[k] - w[k]) > MULTI_METRIC_TOL * max(abs(w[k]), 1e-30):
                raise AssertionError(f"{label} {arch} step {w['step']} {k}: "
                                     f"{h[k]} vs {w[k]}")
        if h["tokens"] != w["tokens"]:
            raise AssertionError(f"{label} {arch} tokens {h} vs {w}")
    want = {"/".join(p): x.cpu() for p, x in tree_paths(tr.state)}
    st = got["state"]
    if sorted(st) != sorted(want) or got["restarts"]:
        raise AssertionError(f"{label} {arch}: leaves or restarts differ")
    pick = {"/".join(p): x.float().cpu()
            for p, x in tree_paths(start["params"])}
    g = {"/".join(p): x.float().cpu() for p, x in tree_paths(grad)}
    int8 = moments == "int8"
    worst = {}
    for tree in ("params", "opt/master"):
        worst[tree] = updates_close(
            {f"{tree}/{k}": v for k, v in pick.items()},
            {k: v.float() for k, v in st.items()},
            {k: v.float() for k, v in want.items()},
            {f"{tree}/{k}": v for k, v in g.items()},
            1.0 / 127 if int8 else MULTI_UPDATE_TOL, 2 * lr_sum, label)
    mom = 0.0
    for k, w in want.items():
        if not k.startswith(("opt/m/", "opt/v/")):
            continue
        err = float((st[k].float() - w.float()).abs().max()
                    / max(float(w.float().abs().max()), 1e-30))
        mom = max(mom, err)
        if err > (1.0 / 127 if int8 else MULTI_MOMENT_TOL):
            raise AssertionError(f"{label} {arch} {k}: {err:.2e}")
    return {"grad_accum": accum, "moments": moments, "update_rel": worst,
            "moment_rel": mom, "launches": {k: v for k, v in
                                            got["launches"].items() if v}}


def phase_multi(device, trace, tables, smi, train14c) -> dict:
    """17 (see the module docstring)."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_data_mesh, make_points_mesh
    from repro_torch.storage.datapipe import SyntheticTokens
    from repro_torch.train.optimizer import OptConfig, tree_paths
    from repro_torch.train.schedules import wsd
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    out = {"17a": {}}
    # -- 17a: the sweeps over points meshes -----------------------------
    meshes = [make_points_mesh(("cuda:0",) * MULTI_SHARDS)]
    if torch.cuda.device_count() >= 2:
        meshes.append(make_points_mesh())
    for mesh in meshes:
        key = ", ".join(str(d) for d in mesh.devices)
        res = out["17a"][key] = multi_sweeps(device, mesh, trace, tables)
        log(f"[17a] points mesh ({key}): every call bit-equal to shard=False; "
            "walls sharded / one device: " + "; ".join(
                f"{k} ({v['points']} points) {v['sharded_s']:.2f} / "
                f"{v['one_device_s']:.2f} s" for k, v in res.items()))

    # -- 17b: the Trainer on a one-rank NCCL mesh, ZeRO-1 ---------------
    cfg = get_arch(TRAIN_ARCH).config
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = make_data_mesh()
            for label, m in (("mesh-less", None), ("data=1, ZeRO-1", mesh)):
                tr = Trainer(cfg, TrainerConfig(
                    steps=MULTI_STEPS, log_every=1, ckpt_every=10 ** 9,
                    ckpt_dir=os.path.join(tmp, str(len(runs))),
                    grad_accum=TRAIN_ACCUM, zero1=True),
                    SyntheticTokens(cfg.vocab_size, batch=TRAIN_BATCH,
                                    seq=TRAIN_SEQ, seed=LM_SEED),
                    ocfg=OptConfig(), schedule=wsd(*TRAIN_WSD),
                    device=None if m is not None else device, mesh=m)
                saved, steps = [], []
                # the final save is recorded, not written (14c writes)
                tr.ckpt.save = lambda step, *a, **kw: saved.append(step)
                step_fn = tr._step

                def timed_step(st, batch, step_fn=step_fn, steps=steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = step_fn(st, batch)
                    torch.cuda.synchronize()
                    steps.append(time.perf_counter() - t0)
                    return res
                tr._step = timed_step
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                reset_kernel_counts()
                res = tr.run()
                counts = kernel_counts()
                runs[label] = {
                    "history": res["history"], "state": tr.state,
                    "step_s": steps, "saved": saved,
                    "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                    "launches": {k: v for k, v in counts.items() if v}}
                del tr
        finally:
            dist.destroy_process_group()
    a, b = runs["mesh-less"], runs["data=1, ZeRO-1"]
    unequal = [("/".join(p)) for (p, x), (_, y) in zip(
        tree_paths(a["state"]), tree_paths(b["state"]))
        if not (x.dtype == y.dtype and torch.equal(x, y))]
    if a["history"] != b["history"] or unequal or a["saved"] != b["saved"]:
        raise AssertionError(f"17b: the one-rank mesh differs from the "
                             f"mesh-less Trainer: leaves {unequal[:5]}, "
                             f"histories {a['history']} / {b['history']}")
    if b["launches"] != a["launches"]:
        raise AssertionError(f"17b: launches {b['launches']} vs "
                             f"{a['launches']}")
    out["17b"] = {label: {k: v for k, v in r.items() if k != "state"}
                  for label, r in runs.items()}
    del runs, a, b
    torch.cuda.empty_cache()
    for label, r in out["17b"].items():
        log(f"[17b] {TRAIN_ARCH} CONFIG, {MULTI_STEPS} Trainer steps of "
            f"{TRAIN_BATCH} x {TRAIN_SEQ} ({TRAIN_ACCUM} microbatches), "
            f"{label}: step s {[round(s, 3) for s in r['step_s']]} (14c: "
            f"{train14c['step_s']:.3f} alone), peak {r['peak_gb']:.2f} GB "
            f"above the start (14c: {train14c['peak_gb']:.2f} GB); launches "
            f"{r['launches']}; {smi}")
    log(f"[17b] the one-rank NCCL mesh with ZeRO-1 bit-equal to the "
        f"mesh-less Trainer: losses, norms and every leaf of the final "
        f"state; losses {[round(h['loss'], 4) for h in out['17b']['mesh-less']['history']]}")

    # -- 17c: two gloo ranks sharing the card ----------------------------
    out["17c"] = multi_two_ranks(device)
    for arch, r in out["17c"].items():
        if arch == "spawn_s":
            continue
        log(f"[17c] {arch} SMOKE (f32, grad_accum {r['grad_accum']}, "
            f"{r['moments']} moments, ZeRO-1) on {MULTI_RANKS} gloo ranks "
            f"sharing cuda:0 against the mesh-less Trainer on the card: "
            f"metrics within {MULTI_METRIC_TOL}, updates within "
            f"{max(r['update_rel'].values()):.2e} of the leaf's largest, "
            f"moments {r['moment_rel']:.2e}; rank 0's launches "
            f"{r['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[17] phase 17 in {out['seconds']:.1f} s (17c's spawn, run and "
        f"join {out['17c']['spawn_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 18: tensor parallelism over ``model`` (gloo ranks sharing cuda:0)
# ---------------------------------------------------------------------------

#: 18a / 18b: two gloo ranks sharing cuda:0 as a (1, 2) mesh (NCCL refuses
#: two ranks on one card); TP_STEPS Trainer steps against the mesh-less
#: Trainer's from the same fresh state in the same call, and the first
#: batch's loss and gradients against the mesh-less ones, with 14b's bars
#: (TRAIN_LOSS_TOL, TRAIN_NORM_TOL, TRAIN_LEAF_TOL).  18a: 14b's qwen2-0.5b
#: CONFIG at full width, its 24 layers cut to TP_QWEN_LAYERS for the
#: script's time (its 2 x 4096 steps take 5–6 s a step on the two ranks,
#: most of it gloo's all-reduces through the host), and 14b's batches;
#: 18b: 14d's recurrentgemma-9b cut (RG_LAYERS, RG_BATCH, int8 moments)
TP_STEPS = 1            # (2 until phase 20 came)
TP_QWEN_LAYERS = 12
TP_TIMEOUT_S = 300
#: 18c: qwen2-0.5b cut to TP_SEQ_LAYERS layers on four ranks as (1, 4):
#: neither its 2 kv heads nor its query groups of 7 divide, so each rank
#: attends from its S / 4 queries to every key; one step of TP_SEQ_BATCH x
#: TRAIN_SEQ against the mesh-less step at the same depth
TP_SEQ_LAYERS, TP_SEQ_BATCH = 4, 1
#: 18d: the same four ranks as (2, 2), SMOKE size at f32 (17c's batches and
#: bars): (arch, grad_accum, moment dtype)
TP_SMOKES = (("qwen2-0.5b", 2, "int8"), ("granite-moe-3b-a800m", 1, "f32"))


class CollectiveLog:
    """Counts the collectives this process issues (calls and bytes, by the
    kinds ``ctx.PlanGroup`` logs: an all-reduce's tensor, an all-gather's
    input, a reduce-scatter's and an all-to-all's whole input) while
    installed, by wrapping ``torch.distributed``'s functions, which
    ``distributed.ctx`` and the optimizer look up at each call."""

    KINDS = {"all_reduce": "all_reduce", "all_gather": "all_gather",
             "reduce_scatter": "reduce_scatter",
             "all_to_all_single": "all_to_all"}

    def __init__(self):
        import torch.distributed as dist
        self.dist = dist
        self.real = {k: getattr(dist, k) for k in self.KINDS}
        self.calls = {k: 0 for k in self.KINDS.values()}
        self.bytes = {k: 0 for k in self.KINDS.values()}

        def wrap(name):
            kind = self.KINDS[name]

            def call(x, *args, **kwargs):
                t = x if name == "all_reduce" else args[0]
                self.calls[kind] += 1
                self.bytes[kind] += sum(y.numel() * y.element_size() for y in
                                        (t if isinstance(t, list) else [t]))
                return self.real[name](x, *args, **kwargs)
            return call
        for k in self.real:
            setattr(dist, k, wrap(k))

    def restore(self) -> dict:
        for k, fn in self.real.items():
            setattr(self.dist, k, fn)
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}


def tp_configs() -> dict:
    """The configs, optimizer configs, grad_accum and batch sources of
    18a, 18b and 18c."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.storage.datapipe import SyntheticTokens
    from repro_torch.train.optimizer import OptConfig
    qwen = get_arch(TRAIN_ARCH).config
    rg = dataclasses.replace(get_arch("recurrentgemma-9b").config,
                             n_layers=RG_LAYERS)
    return {
        "18a": (dataclasses.replace(qwen, n_layers=TP_QWEN_LAYERS),
                OptConfig(), TRAIN_ACCUM, lambda: SyntheticTokens(
                    qwen.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    seed=LM_SEED)),
        "18b": (rg, OptConfig(moment_dtype="int8"), 1, lambda: SyntheticTokens(
            rg.vocab_size, batch=RG_BATCH, seq=TRAIN_SEQ, seed=LM_SEED + 1)),
        "18c": (dataclasses.replace(qwen, n_layers=TP_SEQ_LAYERS),
                OptConfig(), 1, lambda: SyntheticTokens(
                    qwen.vocab_size, batch=TP_SEQ_BATCH, seq=TRAIN_SEQ,
                    seed=LM_SEED + 2))}


def tp_trainer(label, ckpt_dir, device=None, mesh=None):
    """A Trainer of TP_STEPS steps of ``label``'s config on its batches;
    its saves recorded, not written, and each step timed."""
    import torch
    from repro_torch.train.schedules import wsd
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, ocfg, accum, data = tp_configs()[label]
    tr = Trainer(cfg, TrainerConfig(
        steps=TP_STEPS, log_every=1, ckpt_every=10 ** 9,
        ckpt_dir=str(ckpt_dir), grad_accum=accum, zero1=True), data(),
        ocfg=ocfg, schedule=wsd(*TRAIN_WSD), device=device, mesh=mesh)
    tr.saved, tr.step_s = [], []
    tr.ckpt.save = lambda step, *a, **kw: tr.saved.append(step)
    step_fn = tr._step

    def timed_step(st, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step_fn(st, batch)
        torch.cuda.synchronize()
        tr.step_s.append(time.perf_counter() - t0)
        return res
    tr._step = timed_step
    return tr


#: the cases whose whole parameters (the reference step's, with its
#: gradients and activations, and the Trainer's fresh state) do not fit
#: the card once for every rank: drawn one rank at a time
TP_ONE_AT_A_TIME = ("18b",)


def tp_reference(label, mesh, position) -> dict:
    """The mesh-less loss and gradients of ``label``'s first batch on the
    parameters the Trainer draws from its seed, and this rank's slices of
    the parameters and the gradients on ``mesh``.  The ranks share the
    card: where the whole step does not fit it once a rank
    (TP_ONE_AT_A_TIME), one rank at a time draws the whole parameters and
    takes the step."""
    import torch
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.distributed import partitioning as part
    from repro_torch.launch.steps import loss_and_grads, to_device
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import (global_norm, tree_from_paths,
                                             tree_paths)
    cfg, _, accum, data = tp_configs()[label]
    dev = resolve_device("cuda:0")
    batch = to_device(next(iter(data())), dev)
    t0 = time.perf_counter()
    turns = (range(dist.get_world_size()) if label in TP_ONE_AT_A_TIME
             else (position,))
    for turn in turns:
        if turn == position:
            whole = init_params(cfg, torch.Generator(device=dev).manual_seed(
                0), device=dev)
            loss, _, grads = loss_and_grads(cfg, whole, batch, accum)
            leaves = dict(tree_paths(whole))
            index = {p: part.NamedSharding(mesh, s).index(leaves[p].shape,
                                                          position)
                     for p, s in tree_paths(part.param_pspecs(cfg, mesh,
                                                              whole))}
            out = {"loss": float(loss), "norm": float(global_norm(grads)),
                   "batch": batch,
                   "params": tree_from_paths((p, x[index[p]].clone())
                                             for p, x in leaves.items()),
                   "grads": {p: g[index[p]].clone()
                             for p, g in tree_paths(grads)}}
            del whole, leaves, grads
            torch.cuda.empty_cache()
        if len(turns) > 1:
            dist.barrier()
    out["seconds"] = time.perf_counter() - t0
    return out


def leaf_errors(ref, grads, mesh, shards, all_reduce) -> tuple:
    """(the worst, its path) of each whole gradient leaf's relative L2
    distance from the mesh-less one (14b's measure), from this rank's
    slices (``tp_reference``): each leaf's two sums over the slices are
    summed over the model group (``all_reduce``) where ``model`` splits
    the leaf."""
    import torch
    from repro_torch.train.optimizer import tree_paths
    paths = [p for p, _ in tree_paths(grads)]
    sums = torch.stack([torch.stack([
        (g.float() - ref["grads"][p].float()).square().sum(),
        ref["grads"][p].float().square().sum()])
        for p, g in tree_paths(grads)])
    split = torch.tensor([p in shards.sharded for p in paths],
                         device=sums.device)[:, None]
    total = torch.where(split, sums, torch.zeros_like(sums))
    all_reduce(total, group=mesh.model_group)
    total = torch.where(split, total, sums)
    worst = (0.0, None)
    for p, (d, w) in zip(paths, total.tolist()):
        e = math.sqrt(d) / max(math.sqrt(w), LEAF_FLOOR * ref["norm"])
        if e > worst[0]:
            worst = (e, "/".join(p))
    return worst


def grads_against(ref, loss, norm, leaf) -> dict:
    """The loss, the global norm and ``leaf_errors``' worst leaf against
    the mesh-less step's."""
    pnorm = ref["norm"]
    return {"loss": loss, "plain_loss": ref["loss"], "grad_norm": norm,
            "plain_grad_norm": pnorm,
            "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
            "norm_rel": abs(norm - pnorm) / pnorm, "leaf_rel": leaf[0],
            "worst_leaf": leaf[1]}


def tp_seq_step(mesh, position) -> dict:
    """18c on this rank of the (1, 4) mesh: the first batch's loss and
    gradients on its slices against the mesh-less ones, each K4 launch's
    (kind, Sq, Sk, q_offset) recorded, the kernels and collectives
    counted."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.steps import loss_and_grads, model_shards
    from repro_torch.train.optimizer import global_norm
    cfg, _, accum, _ = tp_configs()["18c"]
    ref = tp_reference("18c", mesh, position)
    reset_kernel_counts()
    calls = []
    real_fwd, real_bwd = FK._launch, FK._launch_bwd

    def fwd(name, q, k, *a, **kw):       # a[4]: q_offset
        calls.append(("fwd", q.shape[2], k.shape[2], a[4]))
        return real_fwd(name, q, k, *a, **kw)

    def bwd(q, k, *a, **kw):             # a[9]: q_offset
        calls.append(("bwd", q.shape[2], k.shape[2], a[9]))
        return real_bwd(q, k, *a, **kw)
    FK._launch, FK._launch_bwd = fwd, bwd
    coll = CollectiveLog()
    try:
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(cfg, ref["params"], ref["batch"],
                                        accum, mesh.data_group,
                                        mesh.model_group)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    finally:
        FK._launch, FK._launch_bwd = real_fwd, real_bwd
        collectives = coll.restore()
    counts = {**kernel_counts(), **FK.CHUNK_LAUNCHES}
    shards = model_shards(cfg, mesh, mesh.model_group)
    out = grads_against(ref, float(loss), float(global_norm(grads, shards)),
                        leaf_errors(ref, grads, mesh, shards,
                                    torch.distributed.all_reduce))
    out.update(step_s=step_s, reference_s=ref["seconds"],
               launches={k: v for k, v in counts.items() if v},
               k4_calls=sorted(set(calls)), collectives=collectives)
    return out


def tp_trainer_run(label, mesh, position, ckpt_dir) -> dict:
    """18a / 18b on this rank of the (1, 2) mesh: TP_STEPS Trainer steps,
    the first step's gradients (taken as the optimizer receives them)
    against the mesh-less ones on the same parameters and batch; each
    step timed, the peak, the kernels and the collectives counted.  The
    final save is recorded and not gathered (17b writes saves; the CPU
    tests hold a tensor-parallel save's files)."""
    import torch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.steps import model_shards
    from repro_torch.train import trainer as trainer_mod
    cfg = tp_configs()[label][0]
    ref = tp_reference(label, mesh, position)
    del ref["params"], ref["batch"]     # the Trainer draws its own
    shards = model_shards(cfg, mesh, mesh.model_group)
    first = {}
    real_update, real_gather = steps_mod.adamw_update, \
        trainer_mod.gather_from_mesh

    def update(ocfg, schedule, params, grads, state, *a, **kw):
        if not first:       # the first step's gradients, then drop the ref's
            first["leaf"] = leaf_errors(ref, grads, mesh, shards,
                                        coll.real["all_reduce"])
            del ref["grads"]
            torch.cuda.empty_cache()
        return real_update(ocfg, schedule, params, grads, state, *a, **kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = tp_trainer(label, ckpt_dir, mesh=mesh)
    if label in TP_ONE_AT_A_TIME:       # one rank at a time draws it whole
        draw = tr._fresh_state

        def fresh():
            for turn in range(torch.distributed.get_world_size()):
                if turn == position:
                    state = draw()
                    torch.cuda.empty_cache()
                torch.distributed.barrier()
            return state
        tr._fresh_state = fresh
    steps_mod.adamw_update = update
    trainer_mod.gather_from_mesh = lambda state, *a, **kw: state
    reset_kernel_counts()
    coll = CollectiveLog()
    t0 = time.perf_counter()
    try:
        run = tr.run()
    finally:
        collectives = coll.restore()
        steps_mod.adamw_update = real_update
        trainer_mod.gather_from_mesh = real_gather
    out = {"run_s": time.perf_counter() - t0, "history": run["history"],
           "step_s": tr.step_s, "saved": tr.saved,
           "restarts": run["restarts"],
           "launches": {k: v for k, v in kernel_counts().items() if v},
           "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "collectives": collectives, "reference_s": ref["seconds"]}
    h = run["history"][0]
    out["grads"] = grads_against(ref, h["loss"], h["grad_norm"],
                                 first["leaf"])
    del tr, run
    gc.collect()                # the timed step's closure holds tr
    torch.cuda.empty_cache()
    return out


def tp_rank(rank: int, tmp: str, world: int) -> None:
    """One of ``world`` gloo ranks sharing cuda:0 (a spawned process):
    two ranks run 18a and 18b on (1, 2), four 18c on (1, 4) and 18d on
    (2, 2); each writes what it measured."""
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.storage.checkpoint import gather_from_mesh
    from repro_torch.train.optimizer import tree_paths

    t0 = time.perf_counter()
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, f"store{world}"), world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    out = {"walls": {}}
    try:
        if world == 2:
            mesh = make_data_mesh(model=2, device="cuda:0")
            out["walls"]["start"] = time.perf_counter() - t0
            for label in ("18a", "18b"):
                t1 = time.perf_counter()
                out[label] = tp_trainer_run(label, mesh, rank,
                                            os.path.join(tmp, label))
                out["walls"][label] = time.perf_counter() - t1
        else:
            mesh = make_data_mesh(model=4, device="cuda:0")
            out["walls"]["start"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            out["18c"] = tp_seq_step(mesh, rank)
            torch.cuda.empty_cache()
            out["walls"]["18c"] = time.perf_counter() - t1
            mesh = make_data_mesh(model=2, device="cuda:0")
            for arch, accum, moments in TP_SMOKES:
                t1 = time.perf_counter()
                tr = smoke_trainer(arch, accum, moments,
                                   os.path.join(tmp, f"18d-{arch}"),
                                   mesh=mesh)
                reset_kernel_counts()
                res = tr.run()
                counts = kernel_counts()
                whole = gather_from_mesh(tr.state, tr.state_shardings)
                out[f"18d/{arch}"] = {
                    "history": res["history"], "restarts": res["restarts"],
                    "launches": {k: v for k, v in counts.items() if v},
                    "state": {"/".join(p): x.cpu()
                              for p, x in tree_paths(whole)}}
                out["walls"][f"18d/{arch}"] = time.perf_counter() - t1
        torch.save(out, os.path.join(tmp, f"tp{world}-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_spawn(tmp, world: int) -> tuple[list, float]:
    import os

    import torch
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    # the ranks share the card: growable segments keep their freed blocks
    # from stranding memory the other ranks need (the ranks inherit it)
    prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        mp.start_processes(tp_rank, args=(tmp, world), nprocs=world,
                           join=True, start_method="spawn")
    finally:
        if prev is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
    spawn_s = time.perf_counter() - t0
    return [torch.load(os.path.join(tmp, f"tp{world}-rank{r}.pt"))
            for r in range(world)], spawn_s


def check_tp_grads(label, r) -> None:
    if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
        raise AssertionError(f"{label}: loss {r['loss']} / norm "
                             f"{r['grad_norm']}")
    if (r["loss_rel"] > TRAIN_LOSS_TOL or r["norm_rel"] > TRAIN_NORM_TOL
            or r["leaf_rel"] > TRAIN_LEAF_TOL):
        raise AssertionError(f"{label}: the tensor-parallel gradients vs the "
                             f"mesh-less ones: {r}")


def time_chunk_bwd(device) -> dict:
    """18c's chunk backward alone, at the main path's shape (q [1, 14,
    S / 4, 64] at q_offset r S / 4, k, v [1, 2, S, 64], causal) on each of
    the four chunks: bf16 against the plain version within
    FLASH_BWD_TOL, the keys no row sees exactly 0, the f32 route on the
    last chunk within its bar; the last chunk (the most pairs) timed as
    one call between CUDA events, beside its plain version, its
    operations bound (10 D flops a kept pair at the bf16 tensor-core
    rate) and SDPA's backward with the chunk's boolean mask (forward plus
    backward minus forward, kv heads repeated)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference)
    cfg = tp_configs()["18c"][0]
    h, kvh, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.hd, TRAIN_SEQ
    n = s // 4
    g = torch.Generator(device=device).manual_seed(18)
    k, v = (torch.randn((1, kvh, s, d), generator=g, device=device).bfloat16()
            for _ in range(2))
    out = {"chunks": []}
    for r in range(4):
        off = r * n
        q, do = (torch.randn((1, h, n, d), generator=g,
                             device=device).bfloat16() for _ in range(2))
        routes = [(torch.bfloat16, q, k, v, do)]
        if r == 3:
            routes.append((torch.float32, *(x.float() for x in (q, k, v,
                                                                 do))))
        for dt, qq, kk, vv, dd in routes:
            o, lse = FK.flash_attention_bhsd(qq, kk, vv, q_offset=off,
                                             with_lse=True)
            got = FK.flash_attention_bwd_bhsd(qq, kk, vv, o, dd, lse,
                                              q_offset=off)
            want = attention_backward_reference(qq, kk, vv, o, dd,
                                                q_offset=off)
            torch.cuda.synchronize()
            rel = max(rel_max(x, y) for x, y in zip(got, want))
            err = max(float((x.float() - y.float()).abs().max())
                      for x, y in zip(got, want))
            unseen = torch.arange(s, device=device) > off + n - 1
            zero = all(not bool(x[:, :, unseen].any()) for x in got[1:])
            if rel > FLASH_BWD_TOL[str(dt)] or not zero:
                raise AssertionError(f"18c chunk backward at q_offset {off} "
                                     f"({dt}): {rel:.2e}, unseen keys zero "
                                     f"{zero}")
            out["chunks"].append({"q_offset": off, "dtype": str(dt),
                                  "rel_err": rel, "max_abs_err": err,
                                  "unseen_keys": int(unseen.sum())})
            if dt == torch.bfloat16:
                out.setdefault("ms_by_offset", {})[off] = cuda_ms(
                    lambda: FK.flash_attention_bwd_bhsd(
                        qq, kk, vv, o, dd, lse, q_offset=off))
    # the last chunk: time, plain, bound, SDPA
    last = 3 * n
    t = {"shape": [1, h, n, d], "kv_shape": [1, kvh, s, d], "q_offset": last,
         "ms": out["ms_by_offset"][last],
         "max_abs_err": max(c["max_abs_err"] for c in out["chunks"]
                            if c["dtype"] == str(torch.bfloat16)),
         "f32_max_abs_err": out["chunks"][-1]["max_abs_err"]}
    t["fwd_lse_ms"] = cuda_ms(lambda: FK.flash_attention_bhsd(
        q, k, v, q_offset=last, with_lse=True))
    t["plain_ms"] = cuda_ms(lambda: attention_backward_reference(
        q, k, v, o, do, q_offset=last), warmup=False)
    t["pairs"] = valid_pairs(n, s, True, None, last)
    t["ops"] = 10.0 * d * t["pairs"] * h
    t["bytes"] = (4 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4
    t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["ops"],
                                            ops_per_s=BF16_OPS_PER_S)
    group = h // kvh
    xs = [x.detach().requires_grad_(True) for x in (
        q, k.repeat_interleave(group, dim=1),
        v.repeat_interleave(group, dim=1))]
    qp = last + torch.arange(n, device=device)
    mask = qp[:, None] >= torch.arange(s, device=device)[None, :]
    t["library_ms"] = None
    try:             # the yardstick only, never the path
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            *xs, attn_mask=mask))
        both = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*xs, attn_mask=mask), xs, do))
        t["library_ms"], t["library_fwd_ms"] = both - fwd, fwd
    except RuntimeError as exc:
        log(f"SDPA chunk backward yardstick failed: {exc}")
    out["k4_chunk_bwd"] = t
    return out


def phase_tp(device, smi) -> dict:
    """18 (see the module docstring)."""
    import tempfile

    import torch
    from repro_torch.kernels.flash_attention import kernel as FK

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"main_gb": torch.cuda.memory_allocated() / 1e9}
    # -- the mesh-less Trainer's steps, the references of 18a / 18b ------
    t0 = time.perf_counter()
    history = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label in ("18a", "18b"):
            tr = tp_trainer(label, f"{tmp}/{label}", device=device)
            run = tr.run()
            history[label] = {"history": run["history"], "step_s": tr.step_s,
                              "saved": tr.saved}
            del tr, run
            gc.collect()            # the timed step's closure holds tr
            torch.cuda.empty_cache()
    out["reference_s"] = time.perf_counter() - t0
    # -- 18c's chunk backward alone -------------------------------------
    t0 = time.perf_counter()
    out["chunk"] = time_chunk_bwd(device)
    torch.cuda.empty_cache()
    out["chunk_s"] = time.perf_counter() - t0
    t = out["chunk"]["k4_chunk_bwd"]
    log(f"[18c] K4's backward over a query chunk: q {tuple(t['shape'])} at "
        f"q_offset {' / '.join(map(str, out['chunk']['ms_by_offset']))} "
        f"against k/v {tuple(t['kv_shape'])} "
        f"bf16 (and f32 at {t['q_offset']}) within the plain version's bars, "
        f"unseen keys' dk/dv exactly 0; the last chunk {t['ms']:.3f} ms "
        f"(by offset {out['chunk']['ms_by_offset']}), "
        f"{100 * t['bound_ms'] / t['ms']:.1f} % of the bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['pairs']} kept pairs "
        f"a head), plain {t['plain_ms']:.2f} ms, SDPA with the chunk's mask "
        f"{t['library_ms']} ms; the forward with lse {t['fwd_lse_ms']:.3f} ms")
    # -- 18a / 18b on two ranks, 18c / 18d on four ------------------------
    with tempfile.TemporaryDirectory() as tmp:
        two, out["spawn2_s"] = tp_spawn(tmp, 2)
        four, out["spawn4_s"] = tp_spawn(tmp, 4)
    for label in ("18a", "18b"):
        ref = history[label]
        for r, got in enumerate(two):
            res = got[label]
            check_tp_grads(f"{label} rank {r}", res["grads"])
            # rank 0 alone saves
            if res["restarts"] or res["saved"] != (ref["saved"] if r == 0
                                                   else []):
                raise AssertionError(f"{label} rank {r}: restarts "
                                     f"{res['restarts']}, saves "
                                     f"{res['saved']} ({ref['saved']})")
            for h, w in zip(res["history"], ref["history"]):
                lr = abs(h["loss"] - w["loss"]) / abs(w["loss"])
                nr = abs(h["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                if lr > TRAIN_LOSS_TOL or nr > TRAIN_NORM_TOL:
                    raise AssertionError(f"{label} rank {r} step {w['step']}: "
                                         f"loss {lr:.2e}, norm {nr:.2e}")
        if two[0][label]["history"] != two[1][label]["history"]:
            raise AssertionError(f"{label}: the ranks log other metrics")
        cnt = two[0][label]["launches"]
        if not (cnt.get(FK.TC) and cnt.get(FK.BWD_ROUTES[FK.TC])):
            raise AssertionError(f"{label}: K4 did not run: {cnt}")
        out[label] = {"reference": ref, "ranks": [
            {k: v for k, v in g[label].items()} for g in two]}
    cfg18 = tp_configs()
    for label in ("18a", "18b"):
        ranks = out[label]["ranks"]
        coll = ranks[0]["collectives"]
        g = ranks[0]["grads"]
        log(f"[{label}] {cfg18[label][0].name} ({cfg18[label][0].n_layers} "
            f"layers) on a (1, 2) mesh of gloo ranks sharing cuda:0: the "
            f"first batch's loss {g['loss']:.6f} vs mesh-less "
            f"{g['plain_loss']:.6f} ({g['loss_rel']:.2e}, bar "
            f"{TRAIN_LOSS_TOL}), grad norm {g['norm_rel']:.2e} (bar "
            f"{TRAIN_NORM_TOL}), worst leaf {g['leaf_rel']:.2e} "
            f"({g['worst_leaf']}; bar {TRAIN_LEAF_TOL}; rank 1 "
            f"{ranks[1]['grads']['leaf_rel']:.2e}); {TP_STEPS} Trainer steps' "
            f"losses {[round(h['loss'], 5) for h in ranks[0]['history']]} vs "
            f"{[round(h['loss'], 5) for h in out[label]['reference']['history']]}"
            f"; step s by rank "
            f"{[[round(x, 3) for x in r['step_s']] for r in ranks]} (mesh-less "
            f"{[round(x, 3) for x in out[label]['reference']['step_s']]}; "
            f"two ranks on one card: correctness, not a speed-up); peak by "
            f"rank {[round(r['peak_gb'], 2) for r in ranks]} GB; rank 0's "
            f"launches in the run {ranks[0]['launches']}; all-reduces a step "
            f"{coll['calls']['all_reduce'] / TP_STEPS:.0f} of "
            f"{coll['bytes']['all_reduce'] / TP_STEPS / 1e9:.3f} GB, "
            f"all-gathers {coll['calls']['all_gather'] / TP_STEPS:.0f} of "
            f"{coll['bytes']['all_gather'] / TP_STEPS / 1e9:.3f} GB; {smi}")
    # 18c: every rank's attention on its own chunk, forward and backward
    n = TRAIN_SEQ // 4
    cfg = cfg18["18c"][0]
    out["18c"] = []
    for r, got in enumerate(four):
        g = got["18c"]
        check_tp_grads(f"18c rank {r}", g)
        want = [(kind, n, TRAIN_SEQ, r * n) for kind in ("bwd", "fwd")]
        if g["k4_calls"] != want:
            raise AssertionError(f"18c rank {r}: K4 calls {g['k4_calls']}, "
                                 f"expected {want}")
        cnt = g["launches"]
        if (cnt.get(FK.CHUNK_BWD, 0) != cfg.num_units
                or cnt.get(FK.BWD_ROUTES[FK.TC], 0) != cfg.num_units
                or cnt.get(FK.CHUNK_FWD, 0) != 2 * cfg.num_units
                or cnt.get(FK.TC, 0) != 2 * cfg.num_units):
            raise AssertionError(f"18c rank {r}: launches {cnt}")
        out["18c"].append(g)
    g = out["18c"][0]
    log(f"[18c] {cfg.name} cut to {TP_SEQ_LAYERS} layers on a (1, 4) mesh: "
        f"sequence-sharded attention, each rank's {n} queries at q_offset "
        f"r x {n} against {TRAIN_SEQ} keys (K4 calls by rank "
        f"{[x['k4_calls'] for x in out['18c']]}); one step of "
        f"{TP_SEQ_BATCH} x {TRAIN_SEQ}: loss {g['loss']:.6f} vs mesh-less "
        f"{g['plain_loss']:.6f}, worst leaf by rank "
        f"{[round(x['leaf_rel'], 4) for x in out['18c']]}, norm "
        f"{g['norm_rel']:.2e}; rank 0's launches {g['launches']}; its "
        f"collectives {g['collectives']}; the step {g['step_s']:.2f} s")
    # 18d: the (2, 2) SMOKE runs against the mesh-less Trainer on the card
    out["18d"] = {}
    for arch, accum, moments in TP_SMOKES:
        out["18d"][arch] = smoke_against_meshless(
            "18d", arch, accum, moments, four[0][f"18d/{arch}"], device)
        for other in four[1:]:
            if other[f"18d/{arch}"]["history"] != \
                    four[0][f"18d/{arch}"]["history"]:
                raise AssertionError(f"18d {arch}: the ranks log other "
                                     "metrics")
        r = out["18d"][arch]
        log(f"[18d] {arch} SMOKE (f32, grad_accum {accum}, {moments} "
            f"moments, ZeRO-1) on a (2, 2) mesh of four gloo ranks sharing "
            f"cuda:0 against the mesh-less Trainer on the card: metrics "
            f"within {MULTI_METRIC_TOL}, updates within "
            f"{max(r['update_rel'].values()):.2e} of the leaf's largest, "
            f"moments {r['moment_rel']:.2e}; rank 0's launches "
            f"{r['launches']}")
    out["rank_walls"] = {"2": two[0]["walls"], "4": four[0]["walls"]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[18] phase 18 in {out['seconds']:.1f} s (this process held "
        f"{out['main_gb']:.2f} GB of the card at its start; the mesh-less "
        f"references "
        f"{out['reference_s']:.1f} s, the chunk backward alone "
        f"{out['chunk_s']:.1f} s; spawn, run and join of two ranks "
        f"{out['spawn2_s']:.1f} s, of four {out['spawn4_s']:.1f} s; rank 0's "
        f"walls {out['rank_walls']})")
    return out


# ---------------------------------------------------------------------------
# phase 19: serving under ``model`` (gloo ranks sharing cuda:0)
# ---------------------------------------------------------------------------

#: 19a-19c: ``launch.steps.make_serve_prefill`` / ``make_serve_decode`` on a
#: (data, model) mesh of gloo ranks sharing cuda:0, each rank on its slices
#: of the parameters (``serve_params``) and of the cache, against the
#: mesh-less ``prefill`` + ``decode_step`` at the same depth in the same
#: call: two prompts of SERVE_TP_PROMPTS tokens left-padded into one wave
#: (as ``ServingEngine`` pads them), then SERVE_TP_STEPS greedy decode steps,
#: the mesh fed the mesh-less run's tokens; a cache of SERVE_TP_MAX_SEQ
#: positions, which 2 and 4 divide.  19a: 14b's qwen2-0.5b CONFIG at 18a's
#: cut on (1, 2) (kv heads, FFN, tied vocabulary); 19b: at 18c's cut on
#: (1, 4) (neither heads nor groups divide: the prefill's attention runs
#: each rank's S / 4 queries through K4 at their q_offset); 19c: 14d's
#: recurrentgemma-9b cut on (1, 2) (query groups over one kv head, the
#: RG-LRU's channels; the 2048-token window's ring wraps, 1024 slots a
#: rank).  Each step's logits within SERVE_TP_TOL of the largest (the bf16
#: bar of tests/test_torch_models.py), and a greedy token that differs only
#: where the mesh-less top-2 gap is under the same bar.  19a and 19c run
#: at once on two pairs of the four ranks, 19b after on all four
SERVE_TP_PROMPTS, SERVE_TP_STEPS, SERVE_TP_MAX_SEQ = (4096, 2560), 32, 4128
SERVE_TP_TOL = 2.0 ** -5
SERVE_TP_DEVICE = "cuda:0"
#: 19d: the dry run's plan of one rank's program (``plan_cell(rank=)`` on
#: the meta device) against what the ranks did: for 18a's train step on
#: (1, 2) (ranks 2-3, after 19c) and for 19a's prefill and first decode
#: step, the collectives the plan logs (kind, calls, bytes) equal to
#: CollectiveLog's on that rank, the predicted peak within DRYRUN_PEAK_TOL
#: of the call's measured rise


def serve_tp_configs() -> dict:
    """label -> (config, model ranks) of 19a, 19b and 19c."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    qwen = get_arch(TRAIN_ARCH).config
    rg = get_arch("recurrentgemma-9b").config
    return {"19a": (dataclasses.replace(qwen, n_layers=TP_QWEN_LAYERS), 2),
            "19b": (dataclasses.replace(qwen, n_layers=TP_SEQ_LAYERS), 4),
            "19c": (dataclasses.replace(rg, n_layers=RG_LAYERS), 2)}


def serve_tp_wave(cfg, device):
    """SERVE_TP_PROMPTS' prompts from LM_SEED, left-padded: [B, S]."""
    import numpy as np
    import torch
    rng = np.random.default_rng(LM_SEED + 3)
    width = max(SERVE_TP_PROMPTS)
    toks = np.zeros((len(SERVE_TP_PROMPTS), width), np.int32)
    for r, n in enumerate(SERVE_TP_PROMPTS):
        toks[r, width - n:] = rng.integers(0, cfg.vocab_size, n)
    return torch.as_tensor(toks, device=device)


def serve_tp_run(cfg, params, toks, prefill_fn, decode_fn, feed=None,
                 steps=SERVE_TP_STEPS):
    """``prefill_fn`` on ``toks``, then ``steps`` decode steps, each fed
    its column of ``feed`` (None: the previous call's argmax, the greedy
    run): each call's last logits (float32, on the CPU), the final norm's
    outputs (``transformer._head``'s input), the tokens fed, the
    prefill's and the decode's seconds."""
    import torch
    from repro_torch.models import transformer
    heads, real = [], transformer._head

    def spy(cfg_, params_, h):
        heads.append(h.detach().cpu())
        return real(cfg_, params_, h)

    transformer._head = spy
    s, logits, fed = toks.shape[1], [], []
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, cache = prefill_fn(toks)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            logits.append(out[:, -1].float().cpu())
            t0 = time.perf_counter()
            for i in range(steps):
                tok = (logits[-1][:, :cfg.vocab_size].argmax(-1) if feed is None
                       else feed[:, i]).to(torch.int32)
                fed.append(tok)
                out, cache = decode_fn(cache, tok[:, None].to(toks.device),
                                       s + i)
                logits.append(out[:, -1].float().cpu())
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
    finally:
        transformer._head = real
    return {"logits": torch.stack(logits), "heads": heads,
            "fed": torch.stack(fed, 1), "prefill_s": prefill_s,
            "decode_s": decode_s, "cache": cache}


def serve_tp_reference(label, device) -> dict:
    """The mesh-less greedy run of ``label``'s config on its wave."""
    import torch
    from repro_torch.models.transformer import decode_step, prefill
    cfg, _ = serve_tp_configs()[label]
    params, *_ = lm_params(cfg, device)
    toks = serve_tp_wave(cfg, device)
    run = serve_tp_run(
        cfg, params, toks,
        lambda x: prefill(cfg, params, x, max_seq=SERVE_TP_MAX_SEQ),
        lambda c, x, i: decode_step(cfg, params, c, x, i))
    del params, run["cache"]
    gc.collect()
    torch.cuda.empty_cache()
    return run


def measured_call(fn, seen: dict, name: str):
    """``fn`` whose first call is measured into ``seen[name]``: its
    arguments' bytes and its rise (``CallMemory``) and its collectives
    (``CollectiveLog``)."""
    def call(*args):
        if name in seen:
            return fn(*args)
        mem = CallMemory(*args)
        coll = CollectiveLog()
        try:
            out = fn(*args)
        finally:
            c = coll.restore()
        seen[name] = {"memory": mem.done(), "collectives": c}
        return out
    return call


def planned(cfg, shape, tp, position, **kw) -> dict:
    """``plan_cell(rank=position)`` on a (1, tp) mesh run on meta: its
    collectives, its predicted peak and the meta run's seconds."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.steps import plan_cell
    mesh = MeshSpec(("data", "model"), (1, tp))
    m = dryrun.run_meta(plan_cell(cfg, shape, mesh, rank=position, **kw),
                        mesh)
    return {"collectives": m.collectives,
            "peak_alloc_bytes": m.peak_alloc_bytes, "seconds": m.seconds}


def serve_tp_case(label, mesh, position, feed, plan=False) -> dict:
    """``label`` on this rank: its slices of the parameters drawn whole
    from LM_SEED, the serving steps on the wave fed the mesh-less tokens,
    the first prefill and decode calls measured; with ``plan``, the plans
    of those two calls (19d)."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import (make_serve_decode,
                                          make_serve_prefill, serve_params)
    from repro_torch.models.transformer import init_params
    cfg, tp = serve_tp_configs()[label]
    dev = torch.device(SERVE_TP_DEVICE)
    whole = init_params(cfg, torch.Generator(device=dev).manual_seed(
        LM_SEED), device=dev)
    params = serve_params(cfg, mesh, whole, position)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    groups = {"group": mesh.data_group, "model_group": mesh.model_group}
    pf = make_serve_prefill(cfg, SERVE_TP_MAX_SEQ, **groups)
    dc = make_serve_decode(cfg, SERVE_TP_MAX_SEQ, **groups)
    seen = {}
    toks = serve_tp_wave(cfg, dev)
    reset_kernel_counts()
    run = serve_tp_run(cfg, params, toks,
                       measured_call(lambda x: pf(params, x), seen,
                                     "prefill"),
                       measured_call(lambda c, x, i: dc(params, c, x, i),
                                     seen, "decode"), feed)
    launches = {k: v for k, v in kernel_counts().items() if v}
    from repro_torch.kernels.flash_attention import kernel as FK
    launches.update({k: v for k, v in FK.CHUNK_LAUNCHES.items() if v})
    out = {**{k: v for k, v in run.items() if k != "cache"},
           "launches": launches, "measured": seen,
           "cache_shapes": {k: tuple(v.shape) for k, v in _flat(run["cache"])}}
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    if plan:
        b, s = toks.shape
        out["plans"] = {
            "prefill": planned(cfg, ShapeSpec(label, "prefill", s, b), tp,
                               position, max_seq=SERVE_TP_MAX_SEQ),
            "decode": planned(cfg, ShapeSpec(label, "decode", s, b), tp,
                              position, max_seq=SERVE_TP_MAX_SEQ, index=s)}
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def serve_tp_train(mesh, position) -> dict:
    """19d's train step: 18a's step on this rank of (1, 2), as the
    ``Trainer`` builds it (``mesh_train_step``), on its slices of a state
    drawn whole from seed 0, measured; beside it the plan of the same."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import partitioning as part
    from repro_torch.launch.steps import (abstract_train_state,
                                          init_train_state, mesh_train_step,
                                          to_device, train_state_pspecs)
    from repro_torch.storage.checkpoint import place_on_mesh
    cfg, ocfg, accum, data = tp_configs()["18a"]
    dev = torch.device(SERVE_TP_DEVICE)
    whole = init_train_state(cfg, ocfg, torch.Generator(
        device=dev).manual_seed(0), device=dev)
    specs = train_state_pspecs(cfg, ocfg, mesh,
                               abstract_train_state(cfg, ocfg))
    state = place_on_mesh(whole, part.shardings(mesh, specs), position)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    batch = to_device(next(iter(data())), dev)
    seen = {}
    step = measured_call(mesh_train_step(cfg, ocfg, mesh, position,
                                         grad_accum=accum)[0], seen,
                         "train")
    t0 = time.perf_counter()
    new_state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t0
    del state, new_state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "step_s": step_s, "measured": seen["train"],
            "plan": planned(cfg, ShapeSpec("18a", "train", TRAIN_SEQ,
                                           TRAIN_BATCH), 2, position,
                            ocfg=ocfg, grad_accum=accum)}


def serve_tp_rank(rank: int, tmp: str) -> None:
    """One of four gloo ranks sharing cuda:0 (a spawned process): ranks 0
    and 1 run 19a on their pair's (1, 2) mesh while ranks 2 and 3 run 19c
    and 19d's train step on theirs; then the four run 19b on (1, 4)."""
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import MeshSpec, make_data_mesh

    t0 = time.perf_counter()
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), 4), rank=rank, world_size=4,
        timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    out = {"walls": {}}
    try:
        refs = torch.load(os.path.join(tmp, "feed.pt"))
        wide = make_data_mesh(model=4, device=SERVE_TP_DEVICE)
        # cuBLAS takes its workspace (32 MiB) from the caching allocator at a
        # stream's first product; made here, it is no measured call's rise,
        # which the plans (without it) are held to (DRYRUN_PEAK_TOL)
        warm = torch.ones((16, 16), device=SERVE_TP_DEVICE)
        warm = warm @ warm
        del warm
        alone = [dist.new_group([r]) for r in range(4)]
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        pair = MeshSpec(("data", "model"), (1, 2),
                        devices=wide.devices[:2], data_group=alone[rank],
                        model_group=pairs[rank // 2])
        out["walls"]["start"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        if rank < 2:
            out["19a"] = serve_tp_case("19a", pair, rank % 2, refs["19a"],
                                       plan=True)
            out["walls"]["19a"] = time.perf_counter() - t1
        else:
            out["19c"] = serve_tp_case("19c", pair, rank % 2, refs["19c"])
            out["walls"]["19c"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            out["19d"] = serve_tp_train(pair, rank % 2)
            out["walls"]["19d"] = time.perf_counter() - t1
        dist.barrier()
        t1 = time.perf_counter()
        out["19b"] = serve_tp_case("19b", wide, rank, refs["19b"])
        out["walls"]["19b"] = time.perf_counter() - t1
        torch.save(out, os.path.join(tmp, f"serve{rank}.pt"))
    finally:
        dist.destroy_process_group()


def serve_tp_spawn(tmp) -> tuple[list, float]:
    import os

    import torch
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        mp.start_processes(serve_tp_rank, args=(tmp,), nprocs=4, join=True,
                           start_method="spawn")
    finally:
        if prev is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
    spawn_s = time.perf_counter() - t0
    return [torch.load(os.path.join(tmp, f"serve{r}.pt"))
            for r in range(4)], spawn_s


def serve_tp_check(label, ref, ranks, cfg, dim: int = -1) -> dict:
    """19a-19c's (and 20b's) ranks against the mesh-less run: every call's
    logits (each rank's columns joined, or with ``dim=1`` each data rank's
    rows) within SERVE_TP_TOL of the largest, the greedy tokens equal or
    the mesh-less top-2 gap under the bar; the final norm's outputs of
    model ranks bit-equal across them."""
    import torch
    v = cfg.vocab_size
    got = torch.cat([r["logits"] for r in ranks], dim=dim)[..., :v]
    want = ref["logits"][..., :v]
    scale = max(1.0, float(want.abs().max()))
    errs = [float((g - w).abs().max()) / scale for g, w in zip(got, want)]
    if max(errs) > SERVE_TP_TOL:
        raise AssertionError(f"{label}: logits {max(errs):.3e} of the "
                             f"largest from the mesh-less ones (bar "
                             f"{SERVE_TP_TOL}), by call {errs}")
    top2 = want.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]) / scale
    differ = got.argmax(-1) != want.argmax(-1)
    if bool((differ & (gaps >= SERVE_TP_TOL)).any()):
        raise AssertionError(f"{label}: greedy tokens differ where the "
                             f"mesh-less top-2 gap is over the bar: calls "
                             f"{differ.nonzero().tolist()}")
    for r in ranks[1:] if dim == -1 else ():
        if len(r["heads"]) != len(ranks[0]["heads"]) or not all(
                torch.equal(a, b) for a, b in zip(ranks[0]["heads"],
                                                  r["heads"])):
            raise AssertionError(f"{label}: the final norm's outputs differ "
                                 "across the model ranks")
    return {"logit_err": errs, "prefill_err": errs[0],
            "decode_err": max(errs[1:]), "scale": scale,
            "tokens_differ": int(differ.sum()),
            "tokens_differ_gaps": gaps[differ].tolist(),
            "min_gap": float(gaps.min())}


def plan_vs_measured(label, plan, seen) -> dict:
    """19d: the plan's collectives equal the measured ones; its peak
    within DRYRUN_PEAK_TOL of the measured rise."""
    coll = {k: {"calls": seen["collectives"]["calls"][k],
                "bytes": seen["collectives"]["bytes"][k]}
            for k in seen["collectives"]["calls"]
            if seen["collectives"]["calls"][k]}
    if plan["collectives"] != coll:
        raise AssertionError(f"19d {label}: the plan's collectives "
                             f"{plan['collectives']} != the rank's {coll}")
    rise = seen["memory"]["rise"]
    ratio = plan["peak_alloc_bytes"] / rise
    if abs(ratio - 1.0) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"19d {label}: predicted peak "
                             f"{plan['peak_alloc_bytes']} vs the measured rise "
                             f"{rise}: {ratio:.4f} (bar {DRYRUN_PEAK_TOL})")
    return {"collectives": coll, "predicted_peak": plan["peak_alloc_bytes"],
            "measured_rise": rise, "ratio": ratio,
            "meta_run_s": plan["seconds"]}


def phase_serve_tp(device, smi) -> dict:
    """19 (see the module docstring)."""
    import tempfile

    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    cfgs = serve_tp_configs()
    t0 = time.perf_counter()
    refs = {label: serve_tp_reference(label, device) for label in cfgs}
    out = {"reference_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({k: r["fed"] for k, r in refs.items()},
                   f"{tmp}/feed.pt")
        ranks, out["spawn_s"] = serve_tp_spawn(tmp)
    who = {"19a": ranks[:2], "19b": ranks, "19c": ranks[2:]}
    for label, (cfg, tp) in cfgs.items():
        got = [r[label] for r in who[label]]
        res = serve_tp_check(label, refs[label], got, cfg)
        n_attn = cfg.num_units * sum(sp.mixer == "attn" for sp in cfg.pattern)
        n_rg = (cfg.num_units * sum(sp.mixer == "rglru" for sp in cfg.pattern)
                + sum(sp.mixer == "rglru" for sp in cfg.tail))
        for r, g in enumerate(got):
            cnt = g["launches"]
            want = {FK.TC: n_attn}
            if label == "19b":
                want[FK.CHUNK_FWD] = n_attn
            if n_rg:                       # K5's routes, as the data gives
                want[RK.TOTAL] = n_rg
                want.update({k: cnt[k] for k in RK.ROUTE_KEYS.values()
                             if k in cnt})
            if cnt != want or sum(cnt.get(k, 0) for k in
                                  RK.ROUTE_KEYS.values()) != want.get(
                                      RK.TOTAL, 0):
                raise AssertionError(f"{label} rank {r}: the prefill launched "
                                     f"{cnt}, expected {want}")
        b = len(SERVE_TP_PROMPTS)
        res.update(
            launches=[g["launches"] for g in got],
            prefill_s=[g["prefill_s"] for g in got],
            decode_tokens_per_s=[b * SERVE_TP_STEPS / g["decode_s"]
                                 for g in got],
            reference_prefill_s=refs[label]["prefill_s"],
            reference_decode_tokens_per_s=b * SERVE_TP_STEPS
            / refs[label]["decode_s"],
            collectives={k: g_["collectives"]
                         for k, g_ in got[0]["measured"].items()},
            rises={k: [g["measured"][k]["memory"]["rise"] for g in got]
                   for k in ("prefill", "decode")},
            cache_shapes=got[0]["cache_shapes"])
        out[label] = res
        coll = res["collectives"]
        log(f"[{label}] {cfg.name} ({cfg.n_layers} layers) served on a "
            f"(1, {tp}) mesh of gloo ranks sharing cuda:0 (make_serve_prefill "
            f"/ make_serve_decode, each rank on its slices): "
            f"{len(SERVE_TP_PROMPTS)} prompts of "
            f"{'/'.join(map(str, SERVE_TP_PROMPTS))} tokens left-padded + "
            f"{SERVE_TP_STEPS} decode steps fed the mesh-less greedy tokens; "
            f"logits vs the mesh-less prefill + decode_step: prefill "
            f"{res['prefill_err']:.3e}, worst decode step "
            f"{res['decode_err']:.3e} of the largest {res['scale']:.2f} (bar "
            f"{SERVE_TP_TOL}); greedy tokens differing "
            f"{res['tokens_differ']} (their mesh-less top-2 gaps "
            f"{res['tokens_differ_gaps']}, bar {SERVE_TP_TOL}); final-norm "
            f"outputs bit-equal across the ranks; launches by rank "
            f"{res['launches']}; rank 0's collectives, prefill "
            f"{coll['prefill']}, a decode step {coll['decode']}; prefill s "
            f"by rank {[round(x, 3) for x in res['prefill_s']]} (mesh-less "
            f"{res['reference_prefill_s']:.3f}); decode tokens/s by rank "
            f"{[round(x, 1) for x in res['decode_tokens_per_s']]} (mesh-less "
            f"{res['reference_decode_tokens_per_s']:.1f}); gloo goes through "
            f"host copies: correctness, not speed; rank 0's cache "
            f"{res['cache_shapes']}")
    # 19d: the plans against what the pairs' ranks did (position r of a
    # pair: 19a on rank r, 18a's step on rank 2 + r)
    out["19d"] = {}
    for r in (0, 1):
        d = {k: plan_vs_measured(f"19a {k} position {r}",
                                 ranks[r]["19a"]["plans"][k],
                                 ranks[r]["19a"]["measured"][k])
             for k in ("prefill", "decode")}
        train = ranks[2 + r]["19d"]
        d["train"] = plan_vs_measured(f"18a train position {r}",
                                      train["plan"], train["measured"])
        d["train"]["step_s"] = train["step_s"]
        d["train"]["loss"] = train["loss"]
        out["19d"][r] = d
        log(f"[19d] position {r} of a (1, 2) pair: the meta plan of its "
            f"program (plan_cell(rank={r})) against the card: "
            + "; ".join(f"{k}: collectives {v['collectives']} equal, "
                        f"predicted peak {v['predicted_peak'] / 1e9:.4f} GB "
                        f"vs measured rise {v['measured_rise'] / 1e9:.4f} GB "
                        f"(ratio {v['ratio']:.4f}, bar {DRYRUN_PEAK_TOL}; "
                        f"meta run {v['meta_run_s']:.1f} s)"
                        for k, v in d.items())
            + f"; 18a's step {d['train']['step_s']:.2f} s, loss "
            f"{d['train']['loss']:.5f}")
    out["rank_walls"] = [r["walls"] for r in ranks]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[19] phase 19 in {out['seconds']:.1f} s (the mesh-less references "
        f"{out['reference_s']:.1f} s; spawn, run and join of four ranks "
        f"{out['spawn_s']:.1f} s; rank walls {out['rank_walls']}); {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 20: parameters split over ``data`` (gloo ranks sharing cuda:0)
# ---------------------------------------------------------------------------

#: one spawn of four gloo ranks sharing cuda:0.  20a: 18a's qwen2-0.5b cut
#: (TP_QWEN_LAYERS) with ``fsdp_units`` (ZeRO-3) on 14b's batch
#: (TRAIN_BATCH x TRAIN_SEQ, one microbatch: a row a data rank), one
#: ``mesh_train_step`` step on (2, 1) (ranks 0-1) and on (2, 2), its loss,
#: norm and every gradient leaf against the mesh-less step's at phase 18's
#: bars.  20b: llama4 CONFIG at its published widths cut to
#: FSDP_LLAMA_LAYERS layers (one dense + MoE unit) and FSDP_LLAMA_EXPERTS of
#: its 128 experts, ``fsdp_units`` on (2, 1) (ranks 2-3, beside 20a's pair):
#: phase 19's wave, then FSDP_DECODE_STEPS decode steps fed the mesh-less
#: greedy tokens, at SERVE_TP_TOL.  20c: granite-moe-3b-a800m CONFIG cut to
#: FSDP_MOE_LAYERS layers on (2, 2) under each of FSDP_MOE_MODES, one step
#: on 14b's batch against the mesh-less step at 20a's bars.  20d: the dry
#: run's plans of 20a's (2, 2) step and 20c's ``e_data_f_model`` step
#: against the ranks' collectives (equal) and measured rises
#: (DRYRUN_PEAK_TOL)
FSDP_LLAMA_LAYERS, FSDP_LLAMA_EXPERTS, FSDP_DECODE_STEPS = 2, 8, 8
FSDP_MOE_LAYERS = 4
FSDP_MOE_MODES = ("f_model", "e_data_f_model")
#: 20d's planned steps
FSDP_PLANNED = ("20a", "20c/e_data_f_model")


def fsdp_configs() -> dict:
    """label -> config of 20a, 20b and 20c (one a mode)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    qwen = get_arch(TRAIN_ARCH).config
    llama = get_arch("llama4-maverick-400b-a17b").config
    moe = get_arch("granite-moe-3b-a800m").config
    return {"20a": dataclasses.replace(qwen, n_layers=TP_QWEN_LAYERS,
                                       fsdp_units=True),
            "20b": dataclasses.replace(
                llama, n_layers=FSDP_LLAMA_LAYERS, moe=dataclasses.replace(
                    llama.moe, n_experts=FSDP_LLAMA_EXPERTS)),
            **{f"20c/{m}": dataclasses.replace(moe, n_layers=FSDP_MOE_LAYERS,
                                               moe_shard_mode=m)
               for m in FSDP_MOE_MODES}}


def fsdp_batch(cfg, device) -> dict:
    """14b's first batch for ``cfg``'s vocabulary."""
    from repro_torch.launch.steps import to_device
    from repro_torch.storage.datapipe import SyntheticTokens
    return to_device(next(iter(SyntheticTokens(
        cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=LM_SEED))),
        device)


def fsdp_reference(label, device, path) -> float:
    """The mesh-less loss, norm and gradients of ``label``'s first batch on
    the parameters seed 0 draws, saved to ``path`` (rank 0 takes them
    while 20b's pair serves); its seconds."""
    import torch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import global_norm, tree_paths
    t0 = time.perf_counter()
    cfg = fsdp_configs()[label]
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    batch = fsdp_batch(cfg, device)
    loss, _, grads = loss_and_grads(cfg, params, batch, 1)
    torch.save({"loss": float(loss), "norm": float(global_norm(grads)),
                "grads": {p: g for p, g in tree_paths(grads)}}, path)
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def fsdp_leaf_errors(ref, grads, specs, mesh, position, group) -> tuple:
    """(the worst, its path) of each whole gradient leaf's relative L2
    distance from the mesh-less one (14b's measure), from this rank's
    blocks of them: each rank sums its block's two squares against the
    same block of the mesh-less gradient, weighted by one over the ranks
    holding that block, and ``group`` (the mesh's ranks) sums them."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import partitioning as part
    from repro_torch.train.optimizer import tree_paths
    spec_of = dict(tree_paths(specs))
    paths, rows = [], []
    for p, g in tree_paths(grads):
        sh = part.NamedSharding(mesh, spec_of[p])
        want = ref["grads"][p]
        want = want[sh.index(want.shape, position)].float()
        share = math.prod(sh.blocks) / mesh.size
        rows.append(torch.stack([(g.float() - want).square().sum(),
                                 want.square().sum()]) * share)
        paths.append(p)
    total = torch.stack(rows)
    dist.all_reduce(total, group=group)
    worst = (0.0, None)
    for p, (d, w) in zip(paths, total.tolist()):
        e = math.sqrt(d) / max(math.sqrt(w), LEAF_FLOOR * ref["norm"])
        if e > worst[0]:
            worst = (e, "/".join(p))
    return worst


def fsdp_train(label, mesh, position, group, ref_path, plan=False) -> dict:
    """One ``mesh_train_step`` step of ``label`` at ``position`` of
    ``mesh`` (``group``: its ranks) on its blocks of a state drawn whole
    from seed 0, the call measured (its collectives, its rise); its loss,
    norm and gradients against the mesh-less step's; with ``plan``, the
    dry run's plan of the same step (20d)."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import partitioning as part
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.steps import (abstract_train_state,
                                          init_train_state, mesh_train_step,
                                          train_state_pspecs)
    from repro_torch.storage.checkpoint import place_on_mesh
    from repro_torch.train.optimizer import OptConfig
    cfg, ocfg = fsdp_configs()[label], OptConfig()
    dev = torch.device(SERVE_TP_DEVICE)
    specs = train_state_pspecs(cfg, ocfg, mesh,
                               abstract_train_state(cfg, ocfg))
    whole = init_train_state(cfg, ocfg, torch.Generator(
        device=dev).manual_seed(0), device=dev)
    state = place_on_mesh(whole, part.shardings(mesh, specs), position)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    param_bytes = sum(x.numel() * x.element_size()
                      for x in _leaves(state["params"]))
    batch = fsdp_batch(cfg, dev)
    captured = {}
    real = steps_mod.adamw_update

    def update(ocfg_, schedule, params, grads, *a, **kw):
        captured["grads"] = grads     # read after the measured call
        return real(ocfg_, schedule, params, grads, *a, **kw)
    seen = {}
    step = measured_call(mesh_train_step(cfg, ocfg, mesh, position)[0], seen,
                         "train")
    steps_mod.adamw_update = update
    reset_kernel_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_state, metrics = step(state, batch)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        step_s = time.perf_counter() - t0
    finally:
        steps_mod.adamw_update = real
    launches = {k: v for k, v in kernel_counts().items() if v}
    del state, new_state, metrics
    ref = torch.load(ref_path, map_location=dev)
    leaf = fsdp_leaf_errors(ref, captured.pop("grads"), specs["params"],
                            mesh, position, group)
    out = grads_against(ref, loss, norm, leaf)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    out.update(step_s=step_s, measured=seen["train"], launches=launches,
               param_bytes=param_bytes)
    if plan:
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import MeshSpec
        spec_mesh = MeshSpec(("data", "model"), tuple(mesh.sizes))
        m = dryrun.run_meta(steps_mod.plan_cell(
            cfg, ShapeSpec(label, "train", TRAIN_SEQ, TRAIN_BATCH), spec_mesh,
            ocfg=ocfg, rank=position), spec_mesh)
        out["plan"] = {"collectives": m.collectives,
                       "peak_alloc_bytes": m.peak_alloc_bytes,
                       "seconds": m.seconds}
    return out


def fsdp_serve(mesh, position, feed) -> dict:
    """20b on this rank of a (2, 1) pair: its blocks of the parameters
    drawn whole from LM_SEED, the serving steps (a unit gathered at a
    time) on phase 19's wave fed the mesh-less tokens, the first prefill
    and decode calls measured."""
    import torch
    from repro_torch.launch.steps import (make_serve_decode,
                                          make_serve_prefill, param_shards,
                                          serve_params)
    from repro_torch.models.transformer import init_params
    cfg = fsdp_configs()["20b"]
    dev = torch.device(SERVE_TP_DEVICE)
    whole = init_params(cfg, torch.Generator(device=dev).manual_seed(
        LM_SEED), device=dev)
    params = serve_params(cfg, mesh, whole, position)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    groups = {"group": mesh.data_group, "model_group": None,
              "shards": param_shards(cfg, mesh)}
    pf = make_serve_prefill(cfg, SERVE_TP_MAX_SEQ, **groups)
    dc = make_serve_decode(cfg, SERVE_TP_MAX_SEQ, **groups)
    seen = {}
    reset_kernel_counts()
    run = serve_tp_run(cfg, params, serve_tp_wave(cfg, dev),
                       measured_call(lambda x: pf(params, x), seen,
                                     "prefill"),
                       measured_call(lambda c, x, i: dc(params, c, x, i),
                                     seen, "decode"), feed,
                       steps=FSDP_DECODE_STEPS)
    out = {**{k: v for k, v in run.items() if k != "cache"},
           "launches": {k: v for k, v in kernel_counts().items() if v},
           "measured": seen,
           "param_bytes": sum(x.numel() * x.element_size()
                              for x in _leaves(params))}
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fsdp_rank(rank: int, tmp: str) -> None:
    """One of four gloo ranks sharing cuda:0 (a spawned process): ranks 0
    and 1 run 20a on their pair's (2, 1) mesh while ranks 2 and 3 serve
    20b on theirs; then the four run 20a and 20c on (2, 2), and plan
    20d's steps."""
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import MeshSpec, make_data_mesh

    t0 = time.perf_counter()
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), 4), rank=rank, world_size=4,
        timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    out = {"walls": {}}
    try:
        feed = torch.load(os.path.join(tmp, "feed.pt"))
        wide = make_data_mesh(model=2, device=SERVE_TP_DEVICE)
        warm = torch.ones((16, 16), device=SERVE_TP_DEVICE)  # cuBLAS's
        warm = warm @ warm                                 # workspace (19)
        del warm
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        pair = MeshSpec(("data", "model"), (2, 1), devices=wide.devices[:2],
                        data_group=pairs[rank // 2])
        out["walls"]["start"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        dev = torch.device(SERVE_TP_DEVICE)
        if rank < 2:        # rank 0 takes the mesh-less steps (20b is longer)
            if rank == 0:
                out["walls"]["ref-20a"] = fsdp_reference(
                    "20a", dev, os.path.join(tmp, "ref-20a.pt"))
            dist.barrier(group=pairs[0])
            t1 = time.perf_counter()
            out["20a/2x1"] = fsdp_train("20a", pair, rank % 2, pairs[0],
                                        os.path.join(tmp, "ref-20a.pt"))
            out["walls"]["20a/2x1"] = time.perf_counter() - t1
            if rank == 0:
                out["walls"]["ref-20c"] = fsdp_reference(
                    f"20c/{FSDP_MOE_MODES[0]}", dev,
                    os.path.join(tmp, "ref-20c.pt"))
        else:
            out["20b"] = fsdp_serve(pair, rank % 2, feed)
            out["walls"]["20b"] = time.perf_counter() - t1
        dist.barrier()
        for label in ("20a",) + tuple(f"20c/{m}" for m in FSDP_MOE_MODES):
            t1 = time.perf_counter()
            out[f"{label}/2x2"] = fsdp_train(
                label, wide, rank, None,
                os.path.join(tmp, f"ref-{label.split('/')[0]}.pt"),
                plan=label in FSDP_PLANNED)
            out["walls"][f"{label}/2x2"] = time.perf_counter() - t1
        torch.save(out, os.path.join(tmp, f"fsdp{rank}.pt"))
    finally:
        dist.destroy_process_group()


def fsdp_spawn(tmp) -> tuple[list, float]:
    import os

    import torch
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        mp.start_processes(fsdp_rank, args=(tmp,), nprocs=4, join=True,
                           start_method="spawn")
    finally:
        if prev is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
    spawn_s = time.perf_counter() - t0
    return [torch.load(os.path.join(tmp, f"fsdp{r}.pt"))
            for r in range(4)], spawn_s


def fsdp_param_bytes(cfg, sizes) -> int:
    """Parameter bytes one rank of a ``sizes`` (data, model) mesh holds of
    ``cfg`` under ``param_pspecs`` (meta shapes)."""
    import torch
    from repro_torch.distributed import partitioning as part
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.transformer import init_params
    mesh = MeshSpec(("data", "model"), sizes)
    shape = init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    return part.tree_local_nbytes(shape, part.param_pspecs(cfg, mesh, shape),
                                  mesh)


def phase_fsdp(device, smi) -> dict:
    """20 (see the module docstring)."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models.transformer import decode_step, prefill

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    cfgs = fsdp_configs()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        params, *_ = lm_params(cfgs["20b"], device)
        toks = serve_tp_wave(cfgs["20b"], device)
        ref = serve_tp_run(
            cfgs["20b"], params, toks,
            lambda x: prefill(cfgs["20b"], params, x,
                              max_seq=SERVE_TP_MAX_SEQ),
            lambda c, x, i: decode_step(cfgs["20b"], params, c, x, i),
            steps=FSDP_DECODE_STEPS)
        del params, ref["cache"]
        gc.collect()
        torch.cuda.empty_cache()
        out["serve_reference_s"] = time.perf_counter() - t0
        torch.save(ref["fed"], f"{tmp}/feed.pt")
        ranks, out["spawn_s"] = fsdp_spawn(tmp)
    # 20a / 20c: every rank's step against the mesh-less one
    for key in ("20a/2x1", "20a/2x2") + tuple(f"20c/{m}/2x2"
                                              for m in FSDP_MOE_MODES):
        got = [r[key] for r in ranks if key in r]
        for r, g in enumerate(got):
            check_tp_grads(f"{key} rank {r}", g)
            cnt = g["launches"]
            if not (cnt.get(FK.TC) and cnt.get(FK.BWD_ROUTES[FK.TC])):
                raise AssertionError(f"{key} rank {r}: K4 did not run: {cnt}")
        coll = got[0]["measured"]["collectives"]
        label = key.rsplit("/", 1)[0]
        out[key] = {"ranks": got}
        log(f"[{key[:3]}] {cfgs[label].name} ({cfgs[label].n_layers} layers"
            f"{', fsdp_units' if cfgs[label].fsdp_units else ''}, moe "
            f"{cfgs[label].moe_shard_mode if cfgs[label].moe else '-'}) on a "
            f"{key.rsplit('/', 1)[1]} mesh of gloo ranks sharing cuda:0, one "
            f"step of {TRAIN_BATCH} x {TRAIN_SEQ}: loss {got[0]['loss']:.6f} vs "
            f"mesh-less {got[0]['plain_loss']:.6f} ({got[0]['loss_rel']:.2e}, "
            f"bar {TRAIN_LOSS_TOL}), norm {got[0]['norm_rel']:.2e} (bar "
            f"{TRAIN_NORM_TOL}), worst leaf by rank "
            f"{[round(g['leaf_rel'], 4) for g in got]} ({got[0]['worst_leaf']};"
            f" bar {TRAIN_LEAF_TOL}); step s by rank "
            f"{[round(g['step_s'], 2) for g in got]}; peak by rank "
            f"{[round(g['measured']['memory']['peak_gb'], 2) for g in got]} GB;"
            f" parameter bytes by rank {[g['param_bytes'] for g in got]}; rank "
            f"0's collectives a step: calls {coll['calls']}, GB "
            f"{ {k: round(v / 1e9, 4) for k, v in coll['bytes'].items()} }; "
            f"launches {got[0]['launches']}")
    # a ZeRO-3 rank holds less than 18a's (1, 2) rank by its unit blocks
    qwen18 = dataclasses.replace(cfgs["20a"], fsdp_units=False)
    out["param_bytes_18a"] = fsdp_param_bytes(qwen18, (1, 2))
    out["param_bytes_20a"] = fsdp_param_bytes(cfgs["20a"], (2, 2))
    held = [r["20a/2x2"]["param_bytes"] for r in ranks]
    if not (set(held) == {out["param_bytes_20a"]}
            and out["param_bytes_20a"] < out["param_bytes_18a"]):
        raise AssertionError(f"20a: ranks hold {held} parameter bytes, the "
                             f"plan {out['param_bytes_20a']}, 18a's rank "
                             f"{out['param_bytes_18a']}")
    # 20b: the served pair against the mesh-less run
    served = [r["20b"] for r in ranks[2:]]
    res = serve_tp_check("20b", ref, served, cfgs["20b"], dim=1)
    n_attn = cfgs["20b"].num_units * len(cfgs["20b"].pattern)
    for r, g in enumerate(served):
        if g["launches"].get(FK.TC) != n_attn:
            raise AssertionError(f"20b rank {r}: the prefill launched "
                                 f"{g['launches']}, expected {n_attn} of "
                                 f"{FK.TC}")
    b = len(SERVE_TP_PROMPTS)
    coll = {k: v["collectives"] for k, v in served[0]["measured"].items()}
    res.update(launches=[g["launches"] for g in served],
               prefill_s=[g["prefill_s"] for g in served],
               decode_tokens_per_s=[b * FSDP_DECODE_STEPS / g["decode_s"]
                                    for g in served],
               reference_prefill_s=ref["prefill_s"],
               reference_decode_tokens_per_s=b * FSDP_DECODE_STEPS
               / ref["decode_s"], collectives=coll,
               param_bytes=[g["param_bytes"] for g in served],
               rises={k: [g["measured"][k]["memory"]["rise"] for g in served]
                      for k in ("prefill", "decode")})
    out["20b"] = res
    log(f"[20b] {cfgs['20b'].name} at its published widths cut to "
        f"{cfgs['20b'].n_layers} layers and {FSDP_LLAMA_EXPERTS} experts, "
        f"fsdp_units on a (2, 1) mesh of gloo ranks sharing cuda:0 (a row "
        f"and a block of every unit leaf a rank, a unit gathered at a time): "
        f"{b} prompts of {'/'.join(map(str, SERVE_TP_PROMPTS))} tokens + "
        f"{FSDP_DECODE_STEPS} decode steps fed the mesh-less greedy tokens; "
        f"logits vs mesh-less: prefill {res['prefill_err']:.3e}, worst decode "
        f"step {res['decode_err']:.3e} of the largest {res['scale']:.2f} (bar "
        f"{SERVE_TP_TOL}); greedy tokens differing {res['tokens_differ']} "
        f"(gaps {res['tokens_differ_gaps']}); parameter bytes by rank "
        f"{res['param_bytes']}; gathered a decode step: "
        f"{coll['decode']['bytes']['all_gather'] / 1e9:.4f} GB in "
        f"{coll['decode']['calls']['all_gather']} all-gathers (prefill "
        f"{coll['prefill']['bytes']['all_gather'] / 1e9:.4f} GB); prefill s "
        f"by rank {[round(x, 3) for x in res['prefill_s']]} (mesh-less "
        f"{res['reference_prefill_s']:.3f}); decode tokens/s by rank "
        f"{[round(x, 2) for x in res['decode_tokens_per_s']]} (mesh-less "
        f"{res['reference_decode_tokens_per_s']:.1f}); rises GB "
        f"{ {k: [round(x / 1e9, 3) for x in v] for k, v in res['rises'].items()} }"
        f"; launches by rank {res['launches']}")
    # 20d: the plans against what the ranks did
    out["20d"] = {}
    for label in FSDP_PLANNED:
        key = f"{label}/2x2"
        out["20d"][label] = [plan_vs_measured(
            f"{key} position {r}", g["plan"], g["measured"])
            for r, g in enumerate(out[key]["ranks"])]
        d = out["20d"][label]
        log(f"[20d] {key}: each position's meta plan (plan_cell(rank=r)) "
            f"against the card: collectives equal "
            f"({d[0]['collectives']}); predicted peak / measured rise by "
            f"position "
            f"{[(round(x['predicted_peak'] / 1e9, 4), round(x['measured_rise'] / 1e9, 4), round(x['ratio'], 4)) for x in d]}"
            f" GB (bar {DRYRUN_PEAK_TOL}); meta runs "
            f"{[round(x['meta_run_s'], 1) for x in d]} s")
    out["rank_walls"] = [r["walls"] for r in ranks]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[20] phase 20 in {out['seconds']:.1f} s (the mesh-less serving "
        f"{out['serve_reference_s']:.1f} s, the steps' on rank 0 "
        f"{ranks[0]['walls']['ref-20a']:.1f} + "
        f"{ranks[0]['walls']['ref-20c']:.1f} s; "
        f"spawn, run and join of four ranks {out['spawn_s']:.1f} s; rank "
        f"walls {out['rank_walls']}); {smi}")
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.api import sweep_tables
    from repro_torch.core.maxplus_form import (combo_arrival_offsets,
                                               combo_written_rows,
                                               end_time_from_state)
    from repro_torch.core.sim_ref import simulate_trace_ref
    from repro_torch.kernels import build
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.maxplus import kernel as K
    from repro_torch.kernels.maxplus import ops as maxplus_ops
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.maxplus.ops import _combo_setup
    from repro_torch.kernels.maxplus.ref import maxplus_fold_ref

    dev = resolve_device()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    clock = PhaseClock()

    # -- 1: versions and the card --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}")

    # -- 2: build every kernel source, one nvcc each, all at once -------
    t0 = time.perf_counter()
    sources = (K.SOURCE, FK.SOURCE, FK.EXT_SOURCE, RK.SOURCE)

    def timed_build(source):
        t = time.perf_counter()
        return (*build.build(source), time.perf_counter() - t)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(timed_build, sources))
    for lib_path, ptxas, secs in built:
        regs = [ln.strip() for ln in ptxas.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[2] built {lib_path.name} for sm_90a in {secs:.1f} s; ptxas: "
            f"{' | '.join(regs)}")
    K._library()
    FK._library()
    FK._ext_library()
    RK._library()
    build_s = time.perf_counter() - t0
    log(f"[2] {len(sources)} sources built in parallel in {build_s:.1f} s")
    clock("1-2")

    # -- 3: kernels == plain at a small shape ----------------------------
    phase_small_variants(dev)
    phase_small_many(dev)

    # -- 4 + 5: the main path, with launch counts ------------------------
    trace, tables = sweep_tables_inputs()
    K.reset_launches()
    cell_calls = CellLaunches(maxplus_ops, "maxplus_fold_kernel")
    try:
        tables_report = phase_tables()
    finally:
        cell_calls.restore()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ends = sweep_tables(tables, trace, engine="cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(K.LAUNCHES)
    log(f"[5] sweep_tables(engine='cuda'): {len(tables)} design points x "
        f"{trace.n_ops} ops on {trace.channels}x{trace.ways} in "
        f"{sweep_s:.1f} s (dictionary build included); peak device memory "
        f"{peak_gb:.2f} GB; main-path launches {launches}")
    for branch in ("indexed", "periodic"):
        if launches[branch] < 1:
            raise AssertionError(f"{branch} kernel branch never launched on "
                                 "the main path of phases 4 and 5")
        if launches[f"{branch}/compact"] != launches[branch]:
            raise AssertionError(f"{branch} kernel branch took the dense "
                                 f"route {launches[f'{branch}/dense']} times "
                                 "on the main path of phases 4 and 5")
    if not (ends.shape == (len(tables),) and np.all(np.isfinite(ends))
            and np.all(ends > 0)):
        raise AssertionError(f"sweep end times malformed: {ends}")

    # -- 5: checks against the plain version and the oracle --------------
    t0 = time.perf_counter()
    layout, combos, idx, mats, s0, _, _, _, _ = _combo_setup(
        tables, trace, "eager", dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b, m, n, _ = mats.shape
    # the plain fold takes seconds here: it is timed on its one run
    plain_run = []
    p_ms = cuda_ms(lambda: plain_run.append(maxplus_fold_ref(
        mats, s0, t_steps=trace.n_ops, idx=idx)), reps=1, warmup=False)
    plain_state = plain_run.pop()
    plain_ends = end_time_from_state(plain_state.cpu().numpy(), layout)
    if not np.array_equal(plain_ends, ends):
        raise AssertionError("sweep end times differ from the plain "
                             f"version: max abs "
                             f"{np.max(np.abs(plain_ends - ends))}")
    kern_state = K.maxplus_fold_kernel(mats, s0, t_steps=trace.n_ops,
                                       idx=idx)
    if not torch.equal(kern_state, plain_state):
        raise AssertionError("kernel state != plain state at real size")
    check_prepass("real size", mats, None, None, s0=s0)
    # the numpy oracle on 2 points: in float64 the sweep drifts by float32
    # rounding only (bar T * 2**-24); on timing quantised to DYADIC_US every
    # float32 sum is exact, and the kernel must meet the oracle within 1e-5
    drift = dyadic_err = 0.0
    points = (0, 37 % len(tables))
    exact = [timing_columns(tables[j], lambda q, c: np.round(c / DYADIC_US)
                            * DYADIC_US) for j in points]
    exact_ends = sweep_tables(exact, trace, engine="cuda")
    for q, j in enumerate(points):
        ref64 = simulate_trace_ref(timing_columns(tables[j], lambda q, c: c,
                                                  dtype=np.float64), trace)
        drift = max(drift, rel(float(ends[j]), ref64))
        dyadic_err = max(dyadic_err, rel(float(exact_ends[q]),
                                         simulate_trace_ref(exact[q], trace)))
    if drift > trace.n_ops * F32_DRIFT_PER_OP or dyadic_err > REL_TOL_ORACLE:
        raise AssertionError(f"kernel sweep vs oracle: float64 drift "
                             f"{drift:.2e}, dyadic {dyadic_err:.2e}")
    log(f"[5] real size: B={b} M={m} N={n} T={trace.n_ops}; end times "
        f"bit-equal to the plain version on the card; vs the numpy oracle "
        f"on 2 points: {dyadic_err:.2e} on {DYADIC_US} us-dyadic timing (< "
        f"{REL_TOL_ORACLE}), float32 drift {drift:.2e} vs the float64 "
        f"oracle (< T*2^-24 = {trace.n_ops * F32_DRIFT_PER_OP:.2e})")

    # -- 3 at the real size: the same dictionary, five variants ---------
    gvec = torch.as_tensor(np.stack([
        combo_arrival_offsets(t, combos, layout) for t in tables]),
        device=dev)
    w = combo_written_rows(combos, layout)
    wvec = torch.as_tensor(np.ascontiguousarray(
        np.broadcast_to(w, (b,) + w.shape)), device=dev)
    inputs = variant_inputs(mats, trace.n_ops, 13, dev, gvec=gvec, wvec=wvec)
    inputs = (idx,) + inputs[1:]
    real_err = check_variants("real size", mats, s0, trace.n_ops, inputs,
                              "compact")
    # the dense route at real size on the two indexed variants (on all
    # five until phase 20 came: each plain fold about 2 s)
    real_err = max(real_err, check_variants(
        "real size, -0.0 in s0", mats, refused_s0(s0), trace.n_ops, inputs,
        "dense", names=("indexed", "indexed+energy+arrivals+extras")))

    # -- timing: both routes, pre-pass, plain version, bound -------------
    sweep_t = time_fold(mats, s0, dict(t_steps=trace.n_ops, idx=idx))
    k_ms, b_ms, b_by = (sweep_t[k] for k in ("ms", "bound_ms", "bound_by"))
    log(f"[5] indexed fold at real size: compact route {k_ms:.3f} ms "
        f"(pre-pass {sweep_t['prepass_ms']:.3f} ms, fold alone "
        f"{sweep_t['fold_ms']:.3f} ms, {sweep_t['ns_per_step']:.1f} ns a "
        f"step), dense route "
        f"{sweep_t['dense_ms']:.3f} ms, plain {p_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; the dense count "
        f"{sweep_t['bound_ms_dense_count']:.3f} ms); host dictionary "
        f"build + copy to the card {setup_s:.2f} s of the {sweep_s:.2f} s "
        f"sweep; card: {smi}")

    # periodic branch at the shape the main path gives it: all Table 3
    # cells in one launch (B = 60, M = 32, N = 20, T = 512)
    from repro_torch.core.interface import make_interface
    from repro_torch.core.maxplus_form import init_state, transition_matrices
    from repro_torch.core.nand import chip as nand_chip
    from repro_torch.core.paper_tables import INTERFACE_ORDER, TABLE3
    from repro_torch.core.sim import page_op_params
    cells = [(c, md, wy, k) for c, bm in TABLE3.items()
             for md, bw in bm.items() for wy in bw for k in INTERFACE_ORDER]
    pmats = torch.as_tensor(np.stack([
        transition_matrices(page_op_params(make_interface(k), nand_chip(c),
                                           md, wy), wy)
        for c, md, wy, k in cells]), device=dev)
    ps0 = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
        init_state(), (len(cells), init_state().shape[0]))), device=dev)
    pk = K.maxplus_fold_kernel(pmats, ps0, t_steps=512)
    pp = maxplus_fold_ref(pmats, ps0, t_steps=512)
    pk_dense = K.maxplus_fold_kernel(pmats, refused_s0(ps0), t_steps=512)
    if not (torch.equal(pk, pp) and torch.equal(
            pk_dense, maxplus_fold_ref(pmats, refused_s0(ps0), t_steps=512))):
        raise AssertionError("periodic kernel != plain on the Table 3 batch")
    per_t = time_fold(pmats, ps0, dict(t_steps=512))
    pk_ms, pb_ms, pb_by = (per_t[k] for k in ("ms", "bound_ms", "bound_by"))
    pp_ms = cuda_ms(lambda: maxplus_fold_ref(pmats, ps0, t_steps=512))
    # periodic branch at the real size, for the record
    real_per = time_fold(mats, s0, dict(t_steps=trace.n_ops))
    rk_ms, rb_ms, rb_by = (real_per[k] for k in ("ms", "bound_ms",
                                                 "bound_by"))
    log(f"[5] periodic fold on the Table 3 batch (B={len(cells)} M=32 N=20 "
        f"T=512): compact route {pk_ms:.4f} ms (pre-pass "
        f"{per_t['prepass_ms']:.4f} ms, fold alone {per_t['fold_ms']:.4f} "
        f"ms, {per_t['ns_per_step']:.1f} ns a step; host wall of one call "
        f"{per_t['host_ms']:.4f} ms, of the pre-pass and its flag read "
        f"{per_t['flag_wall_ms']:.4f} ms), dense route "
        f"{per_t['dense_ms']:.3f} ms, plain "
        f"{pp_ms:.3f} ms, bound {pb_ms:.6f} ms ({pb_by}; the dense count "
        f"{per_t['bound_ms_dense_count']:.5f} ms); at real size: compact "
        f"{rk_ms:.3f} ms, dense {real_per['dense_ms']:.3f} ms, bound "
        f"{rb_ms:.4f} ms ({rb_by})")

    # registers (ptxas) and dynamic shared memory of the (max,+) kernels
    # as the sweep and the fleet launch them
    fleet_m1 = 1 + 2 * 2 * SWEEP_CHANNELS * SWEEP_WAYS   # read/write x parity
    resources = {
        name: (*kernel_resources(built[0][1], pattern), smem)
        for name, pattern, smem in (
            ("pre-pass", "22maxplus_compact_kernel", 0),
            ("K1 compact, indexed", "27maxplus_fold_compact_kernelILb1ELb0ELb0E",
             K.smem_bytes("indexed", m, n)),
            ("K1 compact, indexed+energy+sides",
             "27maxplus_fold_compact_kernelILb1ELb1ELb1E",
             K.smem_bytes("indexed", m, n, p=5)),
            ("K2 compact", "27maxplus_fold_compact_kernelILb0ELb0ELb0E",
             K.smem_bytes("periodic", 32, 20)),
            ("K3 compact, arrivals+faults",
             "32maxplus_fold_many_compact_kernelILb1ELb1E",
             K.smem_bytes("many", fleet_m1, n, lanes=FLEET_LANES)),
            ("K1/K2 dense", "19maxplus_fold_kernel", 2 * 4 * n),
            ("K3 dense", "24maxplus_fold_many_kernel", 2 * 4 * n))}
    log("[5] ptxas registers / dynamic shared memory a block (N=146, M=512 "
        "sweep, M1=513 fleet of 512 lanes; K2 at M=32 N=20): " + "; ".join(
            f"{k}: {r} registers, {s} bytes ({spill})"
            for k, (r, spill, s) in resources.items()))

    # the trace-indexed launches of phase 4 (one per Table 3/4/5 cell)
    cell_report = time_cell_launches(cell_calls, launches["indexed"] - 1)
    log(f"[5] the sweep launch apart: 1 x {k_ms:.3f} ms, bound {b_ms:.4f} "
        "ms")

    clock("3-5")

    # -- 6: the fleet; 7: sweeps, streaming, calibration ----------------
    fleet = phase_fleet(dev)
    clock("6")
    streams = phase_sweeps_streams(tables, trace, ends)
    clock("7")

    # -- 8: LM serving through K4 and K5 ---------------------------------
    lm_small = phase_lm_small(dev)
    lm = phase_lm_serve(dev, built[1][1], built[3][1])
    clock("8")

    # -- 9: request-level workloads; K1's main path grows by its launches
    wl = phase_workloads(dev)
    phase9_launches = wl.pop("launches")
    for key, n_wl in phase9_launches.items():
        launches[key] += n_wl
    clock("9")

    # -- 10: the log-depth engines (plain torch, no kernel) --------------
    logdepth = phase_logdepth(dev, trace, tables, ends, sweep_s, setup_s,
                              wl.pop("query"))
    clock("10")

    # -- 11: the FTL; its K1 launches are their own report entry ---------
    ftl_report = phase_ftl(dev)
    clock("11")

    # -- 12: the storage tier; K1's storage launches are their own entry --
    storage = phase_storage(dev, smi)
    clock("12")

    # -- 13: the rest of slice H; K4's launches of 13b-13d are entries ---
    lm_configs = phase_lm_configs(dev)
    clock("13")

    # -- 14: training through K4 and K5, forwards and backwards ---------
    train = phase_train(dev)
    clock("14")

    # -- 15: the dry run's plan against the card -------------------------
    dry = phase_dryrun(dev, {
        "8b": lm["prefill_memory"],
        "13b": lm_configs["qwen2-0.5b"]["prefill_memory"],
        "14b": train["14b"]["memory"], "14d": train["14d"]["memory"]})
    clock("15")

    # -- 16: caller positions and the soft cap through K4's EXT kernels --
    positions = phase_positions(dev)
    clock("16")

    # -- 17: the multi-device paths (points mesh, data-parallel Trainer) --
    multi = phase_multi(dev, trace, tables, smi, train["14c"])
    clock("17")

    # -- 18: tensor parallelism over model (gloo ranks sharing the card) --
    tp = phase_tp(dev, smi)
    clock("18")

    # -- 19: serving under model (gloo ranks sharing the card); the dry
    # run's plan of one rank's program against them -----------------------
    serve_tp = phase_serve_tp(dev, smi)
    clock("19")

    # -- 20: parameters split over data (ZeRO-3, the MoE shard modes; gloo
    # ranks sharing the card); the rank plans against them ----------------
    fsdp = phase_fsdp(dev, smi)
    clock("20")

    summary = {
        "tables": tables_report, "sweep_s": sweep_s,
        "dictionary_setup_s": setup_s,
        "peak_device_gb": peak_gb, "oracle_rel_err_dyadic": dyadic_err,
        "float32_drift_vs_float64_oracle": drift,
        "periodic_real_size_ms": rk_ms, "periodic_real_size_bound_ms": rb_ms,
        "periodic_real_size_dense_ms": real_per["dense_ms"],
        "k1_sweep": {k: v for k, v in sweep_t.items() if k != "out"},
        "k2_table3": {k: v for k, v in per_t.items() if k != "out"},
        "k1_table_cells": cell_report,
        "maxplus_resources": {k: {"registers": r, "dynamic_smem": s}
                              for k, (r, _, s) in resources.items()},
        "fleet": {k: v for k, v in fleet.items() if k not in (
            "launches", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "routes")},
        "streams": streams, "workloads": wl, "logdepth": logdepth,
        "ftl": ftl_report,
        "storage": {k: v for k, v in storage.items()
                    if k not in ("launches", "k1")},
        "lm": {**lm_small, **{k: v for k, v in lm.items()
                              if k not in ("k4", "k5")}},
        "lm_configs": {arch: ({k: v for k, v in r.items() if k != "k4"}
                              if isinstance(r, dict) else r)
                       for arch, r in lm_configs.items()},
        "train": train, "dryrun": dry, "positions": positions,
        "multi": multi, "tp": tp, "serve_tp": serve_tp, "fsdp": fsdp,
        "build_s": build_s,
        "build_source_s": {lib.name: secs for lib, _, secs in built},
        "phase_s": clock.walls,
        "seconds": time.perf_counter() - t_start,
    }
    log("[summary] " + json.dumps(summary))
    log(smi)
    common = {"route": "cuda", "source": "src/repro_torch/csrc/maxplus_fold.cu",
              "library_ms": None}
    def routes(branch, f, err):
        """Both routes of a K1/K2 launch: main-path launches, times."""
        return {"compact": {"launches": launches[f"{branch}/compact"],
                            "ms": f["ms"], "prepass_ms": f["prepass_ms"],
                            "fold_ms": f["fold_ms"],
                            "ns_per_step": f["ns_per_step"]},
                "dense": {"launches": launches[f"{branch}/dense"],
                          "ms": f["dense_ms"], "max_abs_err": err}}
    log(json.dumps({"kernels": [
        {"name": "maxplus_fold (trace-indexed, K1)", **common,
         "replaces": "src/repro/kernels/maxplus/kernel.py:426",
         "launches": launches["indexed"],
         "phase9_launches": phase9_launches["indexed"],
         "max_abs_err": real_err,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "routes": routes("indexed", sweep_t, real_err),
         "bound_ms_dense_count": sweep_t["bound_ms_dense_count"]},
        {"name": "maxplus_fold (trace-indexed, K1, FTL query)", **common,
         "replaces": "src/repro/kernels/maxplus/kernel.py:426",
         "launches": ftl_report["launches"]["indexed"],
         "max_abs_err": ftl_report["k1"]["max_abs_err"],
         "ms": ftl_report["k1"]["ms"],
         "plain_ms": ftl_report["k1"]["plain_ms"],
         "bound_ms": ftl_report["k1"]["bound_ms"],
         "bound_by": ftl_report["k1"]["bound_by"],
         "routes": {r: ftl_report["launches"][f"indexed/{r}"]
                    for r in K.ROUTES},
         "first_launch_route": ftl_report["k1"]["route"],
         "shape_bmnt": ftl_report["k1_shape"]},
        {"name": "maxplus_fold (trace-indexed, K1, storage traces)", **common,
         "replaces": "src/repro/kernels/maxplus/kernel.py:426",
         "launches": storage["launches"]["indexed"],
         "max_abs_err": storage["k1"]["max_abs_err"],
         "ms": storage["k1"]["ms"],
         "plain_ms": storage["k1"]["plain_ms"],
         "bound_ms": storage["k1"]["bound_ms"],
         "bound_by": storage["k1"]["bound_by"],
         "routes": {r: storage["launches"][f"indexed/{r}"]
                    for r in K.ROUTES},
         "first_launch_route": storage["k1"]["route"],
         "shape_bmnt": storage["k1_shape"]},
        {"name": "maxplus_fold (periodic, K2)", **common,
         "replaces": "src/repro/kernels/maxplus/kernel.py:419",
         "launches": launches["periodic"],
         "max_abs_err": float((pk - pp).abs().max()),
         "ms": pk_ms, "plain_ms": pp_ms, "bound_ms": pb_ms,
         "bound_by": pb_by, "routes": routes("periodic", per_t, 0.0),
         "bound_ms_dense_count": per_t["bound_ms_dense_count"]},
        {"name": "maxplus_fold_many (many-trace, K3)", **common,
         "replaces": "src/repro/kernels/maxplus/kernel.py:293",
         **{k: fleet[k] for k in ("launches", "max_abs_err", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "routes", "bound_ms_dense_count")}},
        {"name": "flash_attention (causal / sliding-window GQA, K4)",
         "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:112",
         **lm["k4"],
         "phase19_launches": {label: [g[FK.TC] for g in
                                      serve_tp[label]["launches"]]
                              for label in ("19a", "19b", "19c")},
         "phase20_launches": {
             "20b": [g[FK.TC] for g in fsdp["20b"]["launches"]],
             **{key: [g["launches"][FK.TC] for g in fsdp[key]["ranks"]]
                for key in fsdp if key.startswith(("20a/", "20c/"))}}},
        {"name": "rglru_scan (RG-LRU linear recurrence, K5)",
         "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru/kernel.py:66", **lm["k5"],
         "phase19_launches": {"19c": [g[RK.TOTAL] for g in
                                      serve_tp["19c"]["launches"]]}},
    ] + [
        {"name": f"flash_attention (K4, {arch} prefill, phase {label})",
         "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:112",
         "launches": r["launches"][FK.TC],
         **{k: r["k4"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "sdpa_is_causal_ms", "f32_route_ms", "shape",
             "kv_shape")}}
        for label, arch in (("13b", "qwen2-0.5b"),
                            ("13c", "granite-moe-3b-a800m"),
                            ("13d", "qwen2-vl-2b"))
        for r in (lm_configs[arch],)] + [
        {"name": "flash_attention_bwd (K4 backward: dq, dk, dv from lse; "
                 "bf16 tensor-core route flash_bwd_prep / flash_bwd_dkdv_tc "
                 "/ flash_bwd_sum / flash_bwd_dq_tc)",
         "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:112",
         "launches": train["14c"]["launches"][FK.BWD],
         "routes": {r: train["14c"]["launches"][r]
                    for r in FK.BWD_ROUTES.values()},
         "routes_14a": train["flash_bwd"]["routes"],
         **{k: train["k4_bwd"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "fwd_lse_ms", "shape", "kv_shape")},
         "step_device_ms_14b": train["14b"].get("step_ours_ms"),
         "at_14d": {k: train["k4_bwd_rg"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "fwd_lse_ms", "shape", "kv_shape", "window")},
         "step_device_ms_14d": train["14d"].get("step_ours_ms"),
         "launches_14d": train["14d"]["step_launches"][FK.BWD]},
        {"name": "rglru_scan backward (K5 reverse mode: rglru_scan_ring_bwd "
                 "/ rglru_scan_bwd)",
         "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru/kernel.py:66",
         "launches": train["14d"]["step_launches"][RK.BWD],
         "max_abs_err": 0.0, "library_ms": None,
         **{k: train["k5_bwd"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "scan_ms", "route",
             "shape")}},
        {"name": "flash_attention EXT (K4 with caller positions and the "
                 "logit soft cap in position order: flash_pos_gather's "
                 "sorted copies, then flash_fwd_tc's EXT instantiation on "
                 "the plan's band; phase 16b's step and scoring forward)",
         "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_ext.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:112",
         "launches": positions["16b"]["ext_launches"],
         "max_abs_err": positions["16a"]["tc"]["max_abs_err"],
         "f32_route_max_abs_err": positions["16a"]["f32"]["max_abs_err"],
         **{k: positions["k4_ext"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "fwd_lse_ms", "from_positions_ms", "index_path_ms",
             "cap_alone_ms", "f32_route_ms", "pairs", "tiles", "device",
             "shape", "kv_shape", "softcap")}},
        {"name": "flash_attention_bwd EXT (K4 backward with caller "
                 "positions and the soft cap in position order: "
                 "flash_pos_gather, flash_bwd_prep (delta, lse and dO "
                 "sorted), flash_bwd_dkdv_tc and flash_bwd_dq_tc's EXT "
                 "instantiations, flash_bwd_sum; phase 16b's step)",
         "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_ext.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:112",
         "launches": positions["16b"]["step_ext_launches"][
             FK.EXT_KEYS[FK.BWD_ROUTES[FK.TC]]],
         "max_abs_err": positions["16a"]["tc"]["bwd_max_abs_err"],
         "f32_route_max_abs_err": positions["16a"]["f32"]["bwd_max_abs_err"],
         "rel_err": positions["16a"]["tc"]["bwd_rel_err"],
         "no_cap_factor_rel_err": positions["16a"]["tc"][
             "no_cap_factor_rel_err"],
         **{k: positions["k4_ext"]["bwd_" + k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": positions["k4_ext"]["library_bwd_ms"],
         **{k: positions["k4_ext"][k] for k in (
             "index_path_bwd_ms", "cap_alone_bwd_ms", "f32_route_bwd_ms",
             "pairs", "shape", "kv_shape", "softcap")}},
        {"name": "flash_attention_bwd chunk (K4 backward over a query "
                 "chunk at q_offset, Sq < Sk: the sequence-sharded "
                 "attention of phase 18c, rank 0's step; flash_bwd_prep, "
                 "flash_bwd_dkdv_tc (keys no row sees: zeros), "
                 "flash_bwd_sum, flash_bwd_dq_tc)",
         "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:112",
         "launches": tp["18c"][0]["launches"][FK.CHUNK_BWD],
         "launches_by_rank": [g["launches"][FK.CHUNK_BWD]
                              for g in tp["18c"]],
         **{k: tp["chunk"]["k4_chunk_bwd"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "f32_max_abs_err", "fwd_lse_ms", "shape",
             "kv_shape", "q_offset", "pairs")},
         "ms_by_offset": tp["chunk"]["ms_by_offset"]},
        {"name": "flash_pos_band (the K4 EXT plan's pre-pass: each sorted "
                 "row's and key's band by binary search; one a forward, "
                 "phase 16b's step and scoring)",
         "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_ext.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:112",
         "launches": (positions["16b"]["step_prep_launches"][FK.BAND]
                      + positions["16b"]["score_prep_launches"][FK.BAND]),
         "max_abs_err": positions["prepasses"]["band_max_abs_err"],
         "ms": positions["prepasses"]["band_ms"],
         "plain_ms": positions["prepasses"]["band_plain_ms"],
         "bound_ms": positions["prepasses"]["band_bound_ms"],
         "bound_by": positions["prepasses"]["band_bound_by"],
         "library_ms": None, "sort_ms": positions["prepasses"]["sort_ms"]},
        {"name": "flash_pos_gather (K4 EXT: q, k, v copied in position "
                 "order for the tensor-core kernels; phase 16b's step and "
                 "scoring)",
         "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_ext.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:112",
         "launches": (positions["16b"]["step_prep_launches"][FK.GATHER]
                      + positions["16b"]["score_prep_launches"][FK.GATHER]),
         "max_abs_err": positions["prepasses"]["gather_max_abs_err"],
         "ms": positions["prepasses"]["gather_ms"],
         "plain_ms": positions["prepasses"]["gather_plain_ms"],
         "bound_ms": positions["prepasses"]["gather_bound_ms"],
         "bound_by": positions["prepasses"]["gather_bound_by"],
         "library_ms": None}]}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
