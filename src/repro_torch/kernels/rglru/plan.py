"""Launch plan of the RG-LRU scan kernels, in plain Python.

The scan ``h_t = a_t·h_{t-1} + b_t`` over a, b [B, S, R] has two routes,
chosen by the data alone:

- **ring**: where TMA can read a and b (16-byte aligned base pointers of
  a, b and h, and a row pitch ``R · itemsize`` that is a multiple of 16
  bytes).  A block owns C consecutive channels of one batch row: one
  producer thread streams boxes of Tc steps x C channels of a and b
  through a ring of STAGES stages in shared memory, and C consumer
  threads, one a channel, step the recurrence in sequence order and send
  each stage's h back with a TMA store.
- **simple**: every other input, through the one-thread-a-channel kernel
  that was the first port (64 threads a block, 16 steps a group).

The gradient has the same two routes in reverse mode (``plan_bwd``): g_t
= a_{t+1} g_{t+1} + dh_t stepped from the last step down, db = g and da_t
= g_t h_{t-1}.  A reverse ring stage carries three boxes of Tc steps — a
one step ahead, dh, h one step behind (``bwd_box_rows``) — issued from the
last sequence tile to the first; the rows past S and below 0 that the
boxes reach are zero-filled by TMA, which gives a_S = 0 and h_{-1} = 0.
Its Tc follows from the same STAGE_BYTES over three boxes, and da and db
leave through two double-buffered tiles.

``plan`` (``plan_bwd``) returns the route with its tile, ring depth,
dynamic shared memory and grid.  The wrapper (``kernel.py``) passes them
to the C function, which checks them against its compile-time
instantiations and refuses a launch that disagrees; ``tests/test_torch_rglru_plan.py`` holds
the plan to the limits of TMA and of shared memory.
"""

from __future__ import annotations

from dataclasses import dataclass

RING, SIMPLE = "ring", "simple"

#: channels a ring block may own, largest first
RING_CHANNELS = (128, 64, 32)
#: blocks the ring's channel tile aims for: about one a streaming
#: multiprocessor of the H100's 132
MIN_BLOCKS = 128
#: bytes of one ring stage, a and b boxes together
STAGE_BYTES = 32 * 1024
RING_STAGES = 4
#: h tiles in shared memory (one written while the other is sent)
H_TILES = 2
#: the dynamic shared memory's base is rounded up to 128 bytes
SMEM_ALIGN = 128
#: the simple kernel's block and unroll (``THREADS``, ``UNROLL`` in
#: ``csrc/rglru_scan.cu``)
SIMPLE_THREADS, SIMPLE_UNROLL = 64, 16

#: TMA's alignment of base pointers and row pitches (bytes)
TMA_ALIGN = 16
#: boxes a reverse ring stage carries: a, dh and h
BWD_BOXES = 3
#: output tiles of a reverse ring buffer: da and db
BWD_OUTPUTS = 2


@dataclass(frozen=True)
class Plan:
    route: str             # RING or SIMPLE
    channels: int          # C: channels (threads that step) a block
    steps: int             # Tc: steps a stage (ring) or a group (simple)
    stages: int            # ring depth (0 for the simple route)
    smem_bytes: int        # dynamic shared memory a block
    grid: tuple[int, int]  # (channel tiles, batch rows)


def ring_aligned(r: int, itemsize: int, ptrs) -> bool:
    """Whether TMA can read and write the tensors: every base pointer
    16-byte aligned, and the row pitch a multiple of 16 bytes."""
    return (r * itemsize) % TMA_ALIGN == 0 and all(
        int(p) % TMA_ALIGN == 0 for p in ptrs)


def ring_channels(batch: int, r: int) -> int:
    """C: the largest tile whose grid reaches MIN_BLOCKS, else the
    smallest (the most blocks the shape has)."""
    for c in RING_CHANNELS:
        if batch * -(-r // c) >= MIN_BLOCKS:
            return c
    return RING_CHANNELS[-1]


def ring_smem_bytes(channels: int, steps: int, itemsize: int,
                    stages: int) -> int:
    box = steps * channels * itemsize
    return SMEM_ALIGN + stages * 2 * box + H_TILES * box


def ring_plan(batch: int, s: int, r: int, itemsize: int) -> Plan:
    """The ring route's plan for a, b [batch, s, r] of ``itemsize`` bytes
    an element: a stage of STAGE_BYTES, Tc steps of C channels of a and
    of b."""
    c = ring_channels(batch, r)
    steps = STAGE_BYTES // (2 * c * itemsize)
    return Plan(RING, c, steps, RING_STAGES,
                ring_smem_bytes(c, steps, itemsize, RING_STAGES),
                (-(-r // c), batch))


def simple_plan(batch: int, s: int, r: int) -> Plan:
    """The simple route's plan: 64 channels a block, no shared memory."""
    return Plan(SIMPLE, SIMPLE_THREADS, SIMPLE_UNROLL, 0, 0,
                (-(-r // SIMPLE_THREADS), batch))


def plan(batch: int, s: int, r: int, itemsize: int, ptrs) -> Plan:
    """The route and launch of a scan over [batch, s, r] with elements of
    ``itemsize`` bytes and the data pointers ``ptrs`` (a, b and h): the
    ring where TMA can read and write them, the simple kernel else."""
    if ring_aligned(r, itemsize, ptrs):
        return ring_plan(batch, s, r, itemsize)
    return simple_plan(batch, s, r)


def ring_bwd_smem_bytes(channels: int, steps: int, itemsize: int,
                        stages: int) -> int:
    box = steps * channels * itemsize
    return (SMEM_ALIGN + stages * BWD_BOXES * box
            + H_TILES * BWD_OUTPUTS * box)


def ring_bwd_plan(batch: int, s: int, r: int, itemsize: int) -> Plan:
    """The reverse ring's plan: the forward's channel tile and depth, a
    stage of STAGE_BYTES (rounded down) holding Tc steps of C channels of
    a, dh and h."""
    c = ring_channels(batch, r)
    steps = STAGE_BYTES // (BWD_BOXES * c * itemsize)
    return Plan(RING, c, steps, RING_STAGES,
                ring_bwd_smem_bytes(c, steps, itemsize, RING_STAGES),
                (-(-r // c), batch))


def bwd_box_rows(k: int, steps: int) -> tuple[int, int, int]:
    """First sequence rows of the a, dh and h boxes of reverse tile k."""
    return k * steps + 1, k * steps, k * steps - 1


def plan_bwd(batch: int, s: int, r: int, itemsize: int, ptrs) -> Plan:
    """The route and launch of the reverse scan: the ring where TMA can
    read and write every tensor (``ptrs``: a, h, dh, da and db), the
    simple kernel else."""
    if ring_aligned(r, itemsize, ptrs):
        return ring_bwd_plan(batch, s, r, itemsize)
    return simple_plan(batch, s, r)
