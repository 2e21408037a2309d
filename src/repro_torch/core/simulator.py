"""Timed execution model + discrete-event swap simulator.

Counterpart of ``repro/core/simulator.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_solvers.py``
holds the two equal.

Gives every op index in an ``IterationTrace`` a wall-clock time (roofline-style
``max(flops/peak, bytes/bw)`` per op) and then replays the iteration under an
AutoSwap schedule with the paper's semantics (§IV-E):

* one swap-out stream, one swap-in stream, each serialized;
* swap-out starts when the variable's pre-gap access completes AND the out
  stream is free;
* swap-in is back-scheduled from the next access (prefetch), serialized, and
  may not start while resident load + size would exceed the limit;
* a MALLOC that would push resident load above the limit is *delayed* until a
  pending swap-out completes — this is where visible overhead comes from;
* an access to a variable whose swap-in has not finished stalls compute.

Overhead = (simulated duration - baseline duration) / baseline, the quantity
minimized by the Bayesian-optimized priority score (paper §IV-C, Fig 9).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .events import IterationTrace


# ---------------------------------------------------------------- hardware
@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # FLOP/s for the training dtype
    hbm_bw: float              # device memory bytes/s
    link_bw: float             # device<->host bytes/s (PCIe / DMA), per direction
    op_overhead_s: float = 2e-6    # fixed per-op launch cost
    malloc_cost_s: float = 0.0     # per-malloc driver cost (cudaMalloc path)
    # Device<->device interconnect bytes/s per direction (NVLink / TPU ICI),
    # used by repro.dist's collective cost model.  Defaults to the host link
    # (PCIe peer-to-peer) for GPUs without a dedicated interconnect.
    ici_bw: float = 0.0
    # Per-collective launch/synchronization latency (ring setup, barriers).
    collective_latency_s: float = 5e-6
    # Achieved fraction of peak compute. Calibrated for the paper's testbed
    # against its own Table I iteration times (VGG16 @ batch 100 trains at
    # ~71 ms/iter on the 1080 Ti => ~12.5% of fp32 peak for small CIFAR
    # convs); without this the simulated compute is ~8x too fast and swap
    # transfers can never hide (paper Fig 9 would be unreproducible).
    efficiency: float = 1.0

    @property
    def eff_flops(self) -> float:
        return self.peak_flops * self.efficiency


# The paper's testbed: GTX 1080 Ti (fp32) on PCIe 3.0 x16.  No NVLink: peer
# traffic rides the same PCIe complex as host swaps.
GTX_1080TI = HardwareSpec(
    "gtx1080ti", peak_flops=11.3e12, hbm_bw=484e9, link_bw=12e9, efficiency=0.125,
    ici_bw=12e9,
)
# The reference package's target: TPU v5e (bf16), host DMA modeled at the
# stated 50 GB/s link figure; 0.5 is a typical large-matmul MFU.  ICI at
# ~100 GB/s per direction (1600 Gbps aggregate inter-chip links).
TPU_V5E = HardwareSpec(
    "tpu_v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9, efficiency=0.5,
    ici_bw=100e9,
)
# The port's target: H100 SXM5 (bf16).  The link and the efficiency are the
# card's own, measured by chip_smoke.py's phase 7 in runs A, C and D of
# PERF.md §6 (slice 5) on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name,
# power.limit), each the median over those runs; the rest is the data sheet's.
# The simulator drives a swap-out and a swap-in channel at once, each at
# link_bw, so link_bw is the per-direction rate with both directions busy.
# op_overhead_s and malloc_cost_s keep the defaults; phase 7 prints the card's
# launch and cudaMalloc costs beside them.
H100_SXM = HardwareSpec(
    "h100_sxm",
    peak_flops=989e12,     # dense bf16 tensor-core rate, data sheet
    hbm_bw=3.35e12,        # HBM3, data sheet
    # Pinned 256 MiB copies, D2H and H2D at once on two streams, GB/s per
    # direction: run A 51.04, 48.32; C 29.71, 36.50; D 33.75, 42.70.
    link_bw=39.60e9,       # median of those six
    # bf16 GEMM [2048, 2560] x [2560, 9728], MFU of 989 TFLOP/s: run A 0.7419,
    # C 0.7383, D 0.7381.
    efficiency=0.7383,     # median of those three
    ici_bw=450e9,          # NVLink 4 per direction, data sheet
)
# cudaMalloc-style allocation cost used for the Table I speedup reproduction.
CUDA_MALLOC_COST_S = 180e-6
POOL_LOOKUP_COST_S = 0.4e-6


def assign_times(trace: IterationTrace, hw: HardwareSpec) -> IterationTrace:
    """Populate ``trace.op_times`` from the per-op cost estimates (in place).

    ``trace.op_extra_s`` (op index -> seconds) charges time the roofline
    model cannot see — collective communication tagged by the sharded
    tracer (repro.dist) — so swap windows that overlap a collective are as
    long as the interconnect actually makes them.
    """
    costs = trace.op_costs or {}
    extra = trace.op_extra_s or {}
    times = [0.0] * (trace.num_indices + 1)
    t = 0.0
    for i in range(trace.num_indices):
        times[i] = t
        flops, nbytes = costs.get(i, (0.0, 0.0))
        if flops or nbytes:
            t += max(flops / hw.eff_flops, nbytes / hw.hbm_bw) + hw.op_overhead_s
        t += extra.get(i, 0.0)
    times[trace.num_indices] = t
    trace.op_times = times
    return trace


def iteration_time(
    trace: IterationTrace, hw: HardwareSpec, malloc_cost_s: float = 0.0
) -> float:
    """Baseline iteration wall-time, optionally charging per-malloc driver cost
    (reproduces Table I's cudaMalloc-vs-pool speedup)."""
    if trace.op_times is None:
        assign_times(trace, hw)
    n_mallocs = sum(1 for v in trace.variables if v.size > 0)
    return trace.op_times[-1] + n_mallocs * malloc_cost_s


# ------------------------------------------------------- swap simulation
@dataclass
class SwapDecision:
    """One selected variable with its absence window (op indices)."""

    var: int
    size: int
    out_after: int     # op index of the access after which we swap out
    in_before: int     # op index of the access that needs it back
    # Cross-iteration-boundary absence (paper §VI-B3: weights swapped out after
    # their last access and prefetched before the *next* iteration's first
    # access). in_before < out_after for these.
    wraps: bool = False


@dataclass
class SimResult:
    baseline_s: float
    duration_s: float
    peak_resident: int          # peak resident load under the schedule
    stalls: int = 0             # accesses that waited on swap-in
    delayed_mallocs: int = 0    # mallocs delayed by the limit
    tail_spill_s: float = 0.0   # swap-out stream drain past compute end
    out_events: list[tuple[int, float, float]] = field(default_factory=list)
    in_events: list[tuple[int, float, float]] = field(default_factory=list)

    @property
    def overhead(self) -> float:
        if self.baseline_s <= 0:
            return 0.0
        return max(0.0, (self.duration_s - self.baseline_s) / self.baseline_s)


def simulate_swap_schedule(
    trace: IterationTrace,
    decisions: list[SwapDecision],
    hw: HardwareSpec,
    limit: int | None = None,
) -> SimResult:
    """Replay one iteration under a swap schedule (see module docstring).

    The event loop itself lives in ``runtime.engine`` since the
    multi-tenant runtime landed: this is a 1-tenant run over 2 DMA channels
    (one out + one in — exactly the paper's two serialized streams).  Wider
    or narrower DMA engines, and multiple tenants sharing one budget, go
    through ``runtime`` directly.

    The engine's hot paths are vectorized (prefetch index, pending heap,
    event frontier); the reference package pins them bit-for-bit against its
    frozen pre-vectorization engine, and tests/test_torch_solvers.py pins
    this facade's results to the reference's.
    """
    from ..runtime.engine import simulate_program  # deferred: runtime imports core

    return simulate_program(trace, decisions, hw, limit, channels=2, prefetch="eager")
