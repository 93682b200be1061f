#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold its kernels
against their plain versions.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one report line each (every check raises on failure):

1. versions, and the card's name and power limit from ``nvidia-smi``;
2. build of every kernel source under ``src/repro_torch/csrc``
   (``maxplus_fold.cu``, ``flash_attention.cu``, ``rglru_scan.cu``) for
   ``sm_90a``, one ``nvcc`` each, all started together;
3. the (max,+) fold kernel against ``maxplus_fold_ref`` on the card,
   required equal by ``torch.equal``, in five variants (periodic,
   periodic+energy, indexed, indexed+arrivals+extras,
   indexed+energy+arrivals+extras), each through both routes (the compact
   route on a ``maxplus_form`` dictionary, the dense route on a random
   dictionary the compact route's precondition refuses), at a small shape
   here and at the real size after phase 5 (the dense route there on the
   same dictionary with -0.0 in s0's origin row, which the precondition
   refuses); the compact route's pre-pass against its CPU twin
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
6. the fleet at full width: 512 mixed traces on 8 channels x 16 ways
   (N = 146) of 4096-65536 ops, even lanes with Poisson arrivals at 80 %
   of the drive's own rate, every fourth lane with read-retry-like
   surcharges, plus 32 traces on 4 x 8, through
   ``Simulator.run_many(engine="cuda")`` (one many-trace launch per
   geometry): the kernel bit-equal to its plain version on the whole
   fleet, bit-equal to per-trace ``run(engine="cuda")`` on 8 lanes, the
   ``scan`` engine's ``run_many`` within T * 2^-24, 2 lanes exact against
   the numpy oracle on 0.25 us-dyadic timing; both launches must take the
   compact route; the dense route bit-equal to the plain version on the
   whole fleet too; kernel (both routes, the pre-pass alone), plain and
   bound times and the wall time of both engines' ``run_many``;
7. sweeps, streaming and calibration: ``Simulator.sweep`` equal to phase
   5's ``sweep_tables``; ``sweep_steady_bandwidth_mb_s`` equal to the
   per-point channel bandwidth on the 15 Table 3 SLC write cells;
   ``fit_slc`` equal to the JAX package's fit; the stripe exponents; a
   65536-op ``mixed_trace_chunks`` stream on 4 x 8 MLC bit-equal to the
   scan engine on the materialised trace, and a 262144-op stream timed,
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
   65536-request, 4-page Poisson stream (70 % reads) with a
   ``FaultSpec`` of read retries, jitter, program faults and 10 % hedged
   reads through ``Simulator.run(..., objective="all")`` on ``cuda`` and
   ``scan``: end times within T * 2^-24, energies within 1e-3, the
   query's first K1 launch recorded and held bit-equal to
   ``maxplus_fold_ref`` (its end time the query's), every K1 launch on
   the compact route, ``n_remap_ops > 0``, ``retry_hist`` summing to the
   read ops, scan's p50/p99/p99.9 within 1e-3 of the ``oracle``'s, and a
   4096-request prefix's latencies on the card bit-equal to the CPU's;
   (9b) a 16384-request, 2-page stream under the retry-storm spec plus
   program and erase faults through both dynamic policies on ``scan``,
   the card's placements, parities, completions and latencies bit-equal
   to the CPU's and no op on a retired way.  Each query's wall and ops/s,
   the host's lowering, hedging and fault sampling apart, K1's one call
   beside its bound, the percentiles, ``retry_hist`` and ``n_remap_ops``;
10. the log-depth engines, plain torch on the card (no kernel of ours;
   none may launch): (10a) phase 5's sweep through ``sweep_tables`` on
   its default engine, ``prefix`` (chain combine, segment_len 64), within
   T * 2^-24 of phase 5's ``cuda`` ends and bit-equal to the CPU on 2
   points, ``combine="assoc"`` on 4 points bit-equal to the CPU; its wall
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
   saturating 32768-request overwrite stream (30 % reads) over 90 % of
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
   4096-request prefix priced on the card bit-equal to the CPU; (11b)
   that prefix with program and erase failures (the host translator's
   path) on ``cuda``: ``blocks_retired > 0``, ``retry_hist`` summing to
   the read-class ops, bit-equal to a CPU session; (11c) ``run_stream``
   over 4096-request chunks equal to 11a's one-shot ``scan`` query (end,
   WAF, ``ftl_stats``, ops, bytes), and with per-op faults on the
   4096-request prefix in chunks of 2048 equal to the one-shot query with
   that spec;
   (11d) the 16-point aged sweep (``ftl_bench._scan_vs_host``'s points)
   within 1e-3 of per-point ``run`` (scan) on 4 points, bit-equal to the
   CPU on 2, a warm second sweep equal to the first; (11e) greedy's WAF
   on ``ftl_bench._waf_sweep``'s full-size spec within 10 % of
   ``analytic_waf``.  Every translation, scan and sweep fold of the
   phase is checked to have run on the card.
12. the storage tier (``repro_torch.storage``): (12a) phase 8b's full
   model initialised on the card from the same seed, checkpointed by
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
   recurrentgemma-9b and xlstm-350m, checkpoint-stall plans, the 10 GiB
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

Phases 4 and 5 are the main path of the per-design-point kernel (with the
workload query of 9a, whose K1 launches its report adds, and the FTL
query of 11a and the storage pricing of 12e, each reported as its own
entry), phase 6 that
of the many-trace kernel, ``generate`` in phase 8 that of K4 and K5 (and
the prefills of 13b-13d, each reported as its own K4 entry): the
launch counts are reset just before each and read just after.  The
bounds of the (max,+) kernels count what their inputs need (each input
read once, the dense dictionary by the pre-pass; per step the add/max
pairs of the kept entries and the side operations of the rows the op
writes, read off the pre-pass's records); the dense count, 2*N^2 max/add
operations a step, is printed beside them.  The
line before the last is the JSON kernel report, the last line the JSON
device summary.  Exits non-zero without a result when no CUDA device is
present.
"""

from __future__ import annotations

import json
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
FLEET_LANES, FLEET_CHANNELS, FLEET_WAYS = 512, 8, 16
FLEET_SMALL_LANES, FLEET_SMALL_CHANNELS, FLEET_SMALL_WAYS = 32, 4, 8
FLEET_LOG2_OPS = (12.0, 16.0)
OFFERED_LOAD = 0.8          # arrival rate / the drive's rate on the trace
FAULT_SHARE, FAULT_US = 0.02, (30.0, 120.0)
# phase 7: streams on scale_bench's 4 x 8 MLC geometry
STREAM_CHANNELS, STREAM_WAYS = 4, 8
STREAM_CHECK_OPS, STREAM_CHECK_CHUNK = 65536, 8192
STREAM_OPS, STREAM_CHUNK = 262144, 32768
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
WL_REQUESTS, WL_PAGES, WL_SEED, WL_PREFIX = 65536, 4, 0, 4096
WL_STATIC_FAULTS = dict(wear=0.95, jitter_us=2.0, prog_fail_prob=0.02,
                        hedge_fraction=0.1, seed=17)
WL_DYN_REQUESTS, WL_DYN_PAGES, WL_DYN_SEED = 16384, 2, 1
WL_DYN_FAULTS = dict(wear=1.0, rber_worn=3e-5, max_retries=4,
                     retry_step_us=(500.0, 1000.0, 2000.0, 4000.0),
                     prog_fail_prob=0.02, erase_fail_prob=0.05, seed=7)
PERCENTILE_TOL = 1e-3       # scan vs oracle request-latency percentiles
# phase 10: the prefix sweep held bit-equal to the CPU on these points,
# combine="assoc" run on these
PREFIX_CPU_POINTS, PREFIX_ASSOC_POINTS = (0, 37), (0, 13, 37, 63)
# phase 11: the FTL on 8 x 16 SLC.  11a: the JAX package's default spec
# with blocks raised to FTL_BLOCKS (32768 pages: 1024 blocks took phase 11
# past its 150 s, the time going to sequential translation steps and the
# CPU's eager preconditioning), under a saturating
# overwrite stream over 90 % of the logical space (ftl_bench's
# _bandwidth_cliff); 11b its first FTL_PREFIX requests with block
# failures; 11c in chunks of FTL_CHUNK requests (with per-op faults on
# the first FTL_FAULT_CHUNKED requests, chunks of FTL_FAULT_CHUNK); 11d ftl_bench._scan_vs_host's 16
# points; 11e ftl_bench._waf_sweep's full-size greedy point
FTL_BLOCKS, FTL_PPB, FTL_OP = 512, 64, 0.25
FTL_REQUESTS, FTL_READ_FRACTION, FTL_SEED = 32768, 0.3, 5
FTL_PREFIX, FTL_CHUNK, FTL_FAULT_CHUNKED, FTL_FAULT_CHUNK = \
    4096, 4096, 4096, 2048
# program failures at 1e-4, not 1e-3: at 1e-3 the preconditioning's
# ~2e5 programs (~4e5 at 1024 blocks) fail some 200 times, each marking
# its block bad, and the retirements outrun the 102-block spare pool —
# the drive dies before the stream starts (ftl.translate raises, in the
# JAX package too)
FTL_BLOCK_FAULTS = dict(wear=0.6, jitter_us=0.4, prog_fail_prob=1e-4,
                        erase_fail_prob=1e-3, seed=13)
FTL_OP_FAULTS = dict(wear=0.6, jitter_us=0.4, seed=13)
FTL_AGREEMENT = 1e-3        # ftl_bench's engine agreement gate
FTL_SWEEP_OPS = (0.12, 0.5, 16)      # np.linspace arguments
FTL_SWEEP_REQUESTS, FTL_SWEEP_SEED = 6000, 7
FTL_SWEEP_RUN_POINTS, FTL_SWEEP_CPU_POINTS = (0, 5, 10, 15), (0, 9)
FTL_WAF_BLOCKS, FTL_WAF_REQUESTS, FTL_WAF_SEED, WAF_PIN_TOL = \
    256, 60000, 11, 0.10
# phase 12: the storage tier.  12a checkpoints phase 8b's full model
# (RecurrentGemma-9B, 17.16 GB bf16) through CheckpointEngine; 12b feeds
# the card from a 1 GiB striped token store (a real corpus is terabytes;
# the pipeline's shapes are the training stack's); 12c plans KV offload
# at the 500k-token decode shape; 12d runs examples/ssd_design_space.py's
# planning flows
CKPT_CHANNELS, CKPT_WAYS, CKPT_STEP = 4, 4, 1
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


def check_variants(label, mats, s0, t_steps, inputs, route) -> float:
    """Five kernel-vs-plain variants, each required to take ``route``;
    returns the max abs difference (0.0: every check is torch.equal)."""
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
        f"N={mats.shape[2]} T={t_steps}): 5 variants torch.equal, all "
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
        [maxplus_fold_many_ref(**a) for a in setups]), warmup=False)
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan_res = sim.run_many(fleet, engine="scan")
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t0
    shares = [abs(s_.end_us - e) / e / (t.n_ops * F32_DRIFT_PER_OP)
              for s_, e, t in zip(scan_res, ends, fleet)]
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
        f"{lanes}; run_many(scan) {scan_wall:.1f} s wall, at most "
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


class Recorder:
    """Wraps a module's kernel entry point; keeps clones of the first
    call's tensor arguments."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = self.kwargs = None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.args is None:
            self.args = [a.clone() for a in args]
            self.kwargs = {k: v for k, v in kwargs.items() if k != "out"}
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
    prefill_s = []
    real_prefill = engine_mod.prefill

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_prefill(*a, **kw)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t)
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
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
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
            "peak_device_gb": peak_gb}


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
                                "decode_tokens_per_s", "peak_device_gb")},
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

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_scan = sim.run(stream, faults=spec, objective="all", engine="scan")
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t0
    n_ops = res_scan.n_ops
    drift = rel(res_scan.end_us, res_cuda.end_us)
    e_err = max(rel(getattr(res_scan.energy, f), getattr(res_cuda.energy, f))
                for f in ENERGY_FIELDS)
    if not (n_ops == res_cuda.n_ops == faulty.n_ops
            and drift <= n_ops * F32_DRIFT_PER_OP and e_err <= ENERGY_TOL):
        raise AssertionError(f"scan vs cuda on the workload: {n_ops} / "
                             f"{res_cuda.n_ops} ops, end {drift:.2e} (bar "
                             f"{n_ops * F32_DRIFT_PER_OP:.2e}), energy "
                             f"{e_err:.2e}")
    for r in (res_scan, res_cuda):
        if not (r.n_remap_ops == sampler.n_remap_ops > 0
                and int(r.retry_hist.sum()) == n_reads
                and np.array_equal(r.retry_hist, sampler.retry_hist)):
            raise AssertionError(f"[{r.engine}] n_remap_ops {r.n_remap_ops},"
                                 f" retry_hist {r.retry_hist} over "
                                 f"{n_reads} reads")
    lat = res_scan.request_lat_us
    if not (len(lat) == WL_REQUESTS and np.all(np.isfinite(lat))
            and np.all(lat > 0)):
        raise AssertionError("scan's request latencies malformed")
    t0 = time.perf_counter()
    res_oracle = sim.run(stream, faults=spec, engine="oracle")
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
        f"{cuda_wall:.2f} s wall ({n_ops / cuda_wall:.0f} ops/s; K1 "
        f"{launches['indexed']} launches, all on the compact route), scan "
        f"{scan_wall:.1f} s ({n_ops / scan_wall:.0f} ops/s: the completions "
        f"and the energy folds), oracle {oracle_wall:.1f} s; scan vs cuda "
        f"end {drift:.2e} (< T*2^-24 = {n_ops * F32_DRIFT_PER_OP:.2e}), "
        f"energy {e_err:.2e} (< {ENERGY_TOL}); scan vs oracle percentiles "
        f"{pct_err:.2e} (< {PERCENTILE_TOL}); {res_scan.describe()}")
    log(f"[9a] p50 / p99 / p99.9 {pct['p50_us']:.2f} / {pct['p99_us']:.2f}"
        f" / {pct['p99_9_us']:.2f} us; retry_hist "
        f"{res_scan.retry_hist.tolist()} over {n_reads} reads; n_remap_ops "
        f"{res_scan.n_remap_ops}; {WL_PREFIX}-request prefix "
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
            "rate_ops_per_us": rate, "n_ops": n_ops, "host": host,
            "cuda_wall_s": cuda_wall, "scan_wall_s": scan_wall,
            "oracle_wall_s": oracle_wall, "plain_s": plain_s,
            "scan_ops_per_s": n_ops / scan_wall,
            "percentiles": pct, "percentiles_oracle": pct_oracle,
            "retry_hist": res_scan.retry_hist.tolist(),
            "n_remap_ops": res_scan.n_remap_ops,
            "end_us": {"cuda": res_cuda.end_us, "scan": res_scan.end_us},
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


def profiled(fn) -> dict:
    """Device time and count of the CUDA kernels one call of ``fn`` runs,
    by ``torch.profiler``; "not measured" where it records no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_ms": "not measured", "kernels": "not measured"}
    return {"device_ms": sum(e.time_range.elapsed_us()
                             for e in kernels) / 1e3,
            "kernels": len(kernels)}


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
            f"ftl=16 points, OP {ops_[0]:.2f}..{ops_[-1]:.2f}, 128blk x "
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
        # -- 12a: checkpoint of the full RecurrentGemma-9B ---------------
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
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
            f"{LM_ARCH} params):"
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
    stall = {b: plan_checkpoint_tier(PLAN_CKPT_BYTES, b, device=device)
             for b in PLAN_BUDGETS}
    stall_s = time.perf_counter() - t0
    stall_n = dict(ssd_model.ESTIMATES)
    ssd_model.reset_estimates()
    t0 = time.perf_counter()
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
    t_start = time.perf_counter()

    # -- 1: versions and the card --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}")

    # -- 2: build every kernel source, one nvcc each, all at once -------
    t0 = time.perf_counter()
    sources = (K.SOURCE, FK.SOURCE, RK.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build.build, sources))
    for lib_path, ptxas in built:
        regs = [ln.strip() for ln in ptxas.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[2] built {lib_path.name} for sm_90a; ptxas: "
            f"{' | '.join(regs)}")
    K._library()
    FK._library()
    RK._library()
    log(f"[2] {len(sources)} sources built in parallel in "
        f"{time.perf_counter() - t0:.1f} s")

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
    plain_state = maxplus_fold_ref(mats, s0, t_steps=trace.n_ops, idx=idx)
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
    real_err = max(real_err, check_variants(
        "real size, -0.0 in s0", mats, refused_s0(s0), trace.n_ops, inputs,
        "dense"))

    # -- timing: both routes, pre-pass, plain version, bound -------------
    sweep_t = time_fold(mats, s0, dict(t_steps=trace.n_ops, idx=idx))
    k_ms, b_ms, b_by = (sweep_t[k] for k in ("ms", "bound_ms", "bound_by"))
    p_ms = cuda_ms(lambda: maxplus_fold_ref(mats, s0, t_steps=trace.n_ops,
                                            idx=idx), warmup=False)
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

    # -- 6: the fleet; 7: sweeps, streaming, calibration ----------------
    fleet = phase_fleet(dev)
    streams = phase_sweeps_streams(tables, trace, ends)

    # -- 8: LM serving through K4 and K5 ---------------------------------
    lm_small = phase_lm_small(dev)
    lm = phase_lm_serve(dev, built[1][1], built[2][1])

    # -- 9: request-level workloads; K1's main path grows by its launches
    wl = phase_workloads(dev)
    phase9_launches = wl.pop("launches")
    for key, n_wl in phase9_launches.items():
        launches[key] += n_wl

    # -- 10: the log-depth engines (plain torch, no kernel) --------------
    logdepth = phase_logdepth(dev, trace, tables, ends, sweep_s, setup_s,
                              wl.pop("query"))

    # -- 11: the FTL; its K1 launches are their own report entry ---------
    ftl_report = phase_ftl(dev)

    # -- 12: the storage tier; K1's storage launches are their own entry --
    storage = phase_storage(dev, smi)

    # -- 13: the rest of slice H; K4's launches of 13b-13d are entries ---
    lm_configs = phase_lm_configs(dev)

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
         **lm["k4"]},
        {"name": "rglru_scan (RG-LRU linear recurrence, K5)",
         "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru/kernel.py:66", **lm["k5"]},
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
        for r in (lm_configs[arch],)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
