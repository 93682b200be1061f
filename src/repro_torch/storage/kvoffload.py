"""KV-cache SSD-offload planning for long-context decode.

The port's copy of the JAX package's ``repro.storage.kvoffload``.  For
the 500k-token decode shape the KV state may exceed device memory; a
serving tier then pages cold KV blocks to local SSD, and the sustained
read bandwidth of the SSD interface bounds tokens/s.  This module sizes
the state per architecture, emits the decode loop's request-level
workload — a cold-KV read burst plus a small KV-append write burst per
token, striped over the tier's channels — and prices it on the joint
multi-channel simulation under CONV / SYNC_ONLY / PROPOSED.

Attention-free or windowed-only architectures keep O(1) / O(window)
state per layer and never page: ``plan.applicable = False``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.nand import CellType
from repro_torch.core.sched import lower_static
from repro_torch.core.sim import SSDConfig
from repro_torch.core.trace import OpTrace
from repro_torch.core.workload import RequestStream, kvoffload_requests
from repro_torch.models.transformer import ModelConfig
from repro_torch.storage.ssd_model import estimate_trace_interfaces


@dataclasses.dataclass(frozen=True)
class KVOffloadPlan:
    applicable: bool
    state_bytes_per_seq: int          # total cached state for one sequence
    hot_bytes_per_seq: int            # must stay on the card (windows, recurrent state)
    cold_bytes_per_seq: int           # pageable to SSD
    read_mb_per_token: float          # SSD traffic per decoded token
    tokens_per_s: dict[str, float]    # interface -> sustainable decode rate
    trace: OpTrace | None = None      # per-token op trace (window)
    requests: RequestStream | None = None   # placement-free workload window
    note: str = ""


def kv_bytes_per_token(cfg: ModelConfig) -> tuple[int, int]:
    """(hot, cold) cache bytes added per token for one sequence."""
    hot = cold = 0
    dtype_bytes = 2  # bf16 cache
    for spec in tuple(cfg.pattern) + tuple(cfg.tail):
        if spec.mixer != "attn":
            continue  # recurrent state is O(1), stays hot
        per_tok = 2 * cfg.n_kv_heads * cfg.hd * dtype_bytes
        if spec.window is None:
            cold += per_tok
        # a windowed layer's ring buffer is O(window), not per-token
    # the pattern counts once per unit (the tail's layers too, as in the
    # JAX package)
    return hot, cold * cfg.num_units


def plan_kv_offload(cfg: ModelConfig, seq_len: int, *,
                    channels: int = 4, ways: int = 8,
                    cell: CellType = CellType.MLC,
                    device: torch.device | str | None = None
                    ) -> KVOffloadPlan:
    hot_rate, cold_rate = kv_bytes_per_token(cfg)
    if cold_rate == 0:
        return KVOffloadPlan(
            applicable=False, state_bytes_per_seq=0, hot_bytes_per_seq=0,
            cold_bytes_per_seq=0, read_mb_per_token=0.0, tokens_per_s={},
            note=f"{cfg.name}: attention-free / windowed-only — state is "
                 f"O(1)/O(window) per layer; KV offload inapplicable.")
    cold_total = cold_rate * seq_len
    # decode touches the whole cold KV once per token (full-attention read)
    # and appends one token's KV — a mixed read/write workload per token
    read_mb = cold_total / 1e6
    per_token_mb = (cold_total + cold_rate) / 1e6   # read burst + KV append
    # the stripe lowering depends only on geometry/cell, not on the
    # interface kind, so one fan-out prices all three interfaces
    base = SSDConfig(cell=cell, channels=channels, ways=ways)
    requests = kvoffload_requests(cold_total, base, n_tokens=2,
                                  append_bytes_per_token=cold_rate)
    trace = lower_static(requests, base.channels, base.ways).trace
    rates = {kind: est.bandwidth_mb_s / per_token_mb
             for kind, est in estimate_trace_interfaces(
                 trace, base, device=device).items()}
    return KVOffloadPlan(
        applicable=True,
        state_bytes_per_seq=cold_total,
        hot_bytes_per_seq=hot_rate * seq_len,
        cold_bytes_per_seq=cold_total,
        read_mb_per_token=read_mb,
        tokens_per_s=rates,
        trace=trace,
        requests=requests,
        note=f"{cfg.name}: full-attention KV {cold_total/2**30:.1f} GiB/seq at "
             f"S={seq_len}; PROPOSED sustains "
             f"{rates['proposed']:.2f} tok/s vs CONV {rates['conv']:.2f}.")
