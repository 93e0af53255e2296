"""Instruction-throughput-aware roofline model (paper §4, Eq. 6).

P  <=  min( pi,  beta * I_MEM,  gamma * I_COP )

with pi = peak matmul FLOP/s, beta = HBM bytes/s, gamma = peak
coefficient-wise op (COP) throughput.  Port of ``src/repro/core/roofline.py``:
the reference's GPU and host profiles (paper Table 1 and its ``"cpu"``
host), one profile of the card the port runs on (``"h100"``), and the
kernel cost accounting of Appendix A.3/A.5 (I_MEM Eq. 20, COPs-per-dot
C).  The profiles hold peaks, so the model's time is a bound: a measured
time below it means a count is wrong.  How the port's own CUDA kernels
are priced (their split tensor-core passes, their epilogue) lives in
``repro_torch.search.plan``, not in a profile.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = [
    "Hardware",
    "HARDWARE",
    "KernelCost",
    "attainable_flops",
    "bottleneck",
    "cops_per_dot",
    "partial_reduce_cost",
    "partial_reduce_fused_cost",
    "RooflineTerms",
    "roofline_terms",
]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # pi  [FLOP/s]
    hbm_bandwidth: float       # beta [bytes/s]
    peak_cops: float           # gamma [COP/s]
    hbm_bytes: float = 16e9    # per-device HBM capacity
    ici_bandwidth: float = 50e9  # per-link interconnect [bytes/s]
    # Fast on-chip memory available to one kernel instance (GPU: the
    # shared memory a block can take).  The port's kernels have fixed
    # tiles, so its planner only reports it.
    vmem_bytes: float = 16 * 2**20


HARDWARE: Dict[str, Hardware] = {
    # Paper Table 1 (the reference's profiles, unchanged).
    "v100": Hardware("GPU V100", 125e12, 900e9, 15.7e12),
    "a100": Hardware("GPU A100", 312e12, 1555e9, 19.5e12),
    # NVIDIA H100 SXM5 80GB (NVIDIA's H100 data sheet, dense rates at the
    # 700 W limit): 989.4 TFLOP/s bf16 on the tensor cores (the split
    # products of the port's scan), 3.35 TB/s of HBM3, 80 GB.  gamma: 132
    # SMs x 128 FP32 lanes x 1.98 GHz boost clock (the SM count as
    # torch.cuda.get_device_properties reads it on the card).  NVLink 4:
    # 18 links, 900 GB/s a GPU in both directions together; the SXM part
    # reaches its peers through NVSwitch, so its "link" here is all 18,
    # 450 GB/s each way.
    # vmem: the most dynamic shared memory one block can take (227 KB,
    # sharedMemPerBlockOptin).
    "h100": Hardware("GPU H100", 989.4e12, 3.35e12, 132 * 128 * 1.98e9,
                     hbm_bytes=80e9, ici_bandwidth=450e9,
                     vmem_bytes=227 * 1024),
    # Development host (the reference's profile, unchanged): rough orders
    # of magnitude for a server-class CPU socket; only the ratios of the
    # walls matter to the planner.
    "cpu": Hardware("CPU host", 0.5e12, 100e9, 0.1e12, hbm_bytes=64e9),
}


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Workload description of one kernel: FLOPs, HBM bytes, COPs."""

    flops: float
    hbm_bytes: float
    cops: float

    @property
    def i_mem(self) -> float:
        return self.flops / max(self.hbm_bytes, 1e-30)

    @property
    def i_cop(self) -> float:
        return self.flops / max(self.cops, 1e-30)


def attainable_flops(cost: KernelCost, hw: Hardware) -> float:
    """Eq. 6: attainable performance of a kernel on given hardware."""
    return min(hw.peak_flops, hw.hbm_bandwidth * cost.i_mem, hw.peak_cops * cost.i_cop)


def bottleneck(cost: KernelCost, hw: Hardware) -> str:
    """The binding wall of Eq. 6: "compute", "memory" or "instruction"."""
    terms = {
        "compute": hw.peak_flops,
        "memory": hw.hbm_bandwidth * cost.i_mem,
        "instruction": hw.peak_cops * cost.i_cop,
    }
    return min(terms, key=terms.get)


def partial_reduce_cost(
    m: int,
    n: int,
    d: int,
    l: int,
    *,
    cops_per_dot: float = 3.0,
    block_rows: int = 512,
    dtype_bytes: int = 4,
    db_bytes: float = None,
) -> KernelCost:
    """Cost model of the PartialReduce kernel (Appendix A.3).

    FLOPs  = 2MND (the einsum)
    bytes  = 4(MD + MND/ib + 2ML)  -- Eq. 20, ib = query block rows
    COPs   = C * M * N             -- C per dot product (A.5 accounting)

    ``db_bytes`` prices the database-stream term (the MND/ib bytes) apart
    from the query/winner traffic (a storage tier's narrower rows);
    ``None`` keeps the single-dtype Eq. 20 form.
    """
    if db_bytes is None:
        db_bytes = dtype_bytes
    flops = 2.0 * m * n * d
    hbm = (
        dtype_bytes * (m * d + 2 * m * l)
        + db_bytes * (m / block_rows) * n * d
    )
    cops = cops_per_dot * m * n
    return KernelCost(flops=flops, hbm_bytes=hbm, cops=cops)


def partial_reduce_fused_cost(
    m: int,
    n: int,
    d: int,
    k_scan: int,
    *,
    cops_per_dot: float = 3.0,
    block_rows: int = 512,
    dtype_bytes: int = 4,
    db_bytes: float = None,
    block_n: int = 1024,
    bins_per_block: int = 64,
) -> KernelCost:
    """Cost model of the single-pass fused scan→select kernel (Eq. 20).

    FLOPs  = 2MND (the einsum, unchanged)
    bytes  = dtype(MD) + db_bytes * ceil(M/ib) * ND + 8 M k_scan
    COPs   = C*M*N + M * (N/block_n) * k_scan * (k_scan + bins_per_block)

    Against :func:`partial_reduce_cost`, the ``2ML`` bin-winner term
    collapses to the O(M·k_scan) result: the carry stays on chip across
    the database stream.  Each query block streams the whole database
    once (the integer pass count ``ceil(M/ib)``), and the extra COP term
    prices the on-chip merge of each database tile into the carry.
    """
    if db_bytes is None:
        db_bytes = dtype_bytes
    passes = max(1, -(-m // block_rows))  # ceil, floored at one stream
    flops = 2.0 * m * n * d
    hbm = (
        dtype_bytes * m * d
        + db_bytes * passes * n * d
        + 8.0 * m * k_scan
    )
    tiles = max(1.0, n / max(1, block_n))
    cops = (
        cops_per_dot * m * n
        + m * tiles * k_scan * (k_scan + bins_per_block)
    )
    return KernelCost(flops=flops, hbm_bytes=hbm, cops=cops)


def cops_per_dot(
    *,
    base: int = 3,
    l2: bool = False,
    non_pow2_n: bool = False,
    padded_d: bool = False,
    broadcast_norm: bool = False,
) -> int:
    """Appendix A.5 COP accounting: 3 base + 1 per listed condition."""
    c = base
    c += int(l2)              # relaxed distance subtract
    c += int(non_pow2_n)      # database masking
    c += int(padded_d)        # D not a multiple of 128
    c += int(broadcast_norm)  # broadcasting ||x||^2/2
    return c


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Three-term time decomposition for a step on one or more devices."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        # Lower bound: perfectly overlapped execution is max(); serialized
        # is sum().  The roofline convention reports the max.
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(
    *,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    chips: int,
    hw: Hardware,
    ici_links: int = 1,
) -> RooflineTerms:
    """Three-term roofline for a whole step:

    compute    = FLOPs / (chips * pi)
    memory     = bytes / (chips * HBM bw)
    collective = collective bytes / (chips * ici_links * link bw)
    """
    return RooflineTerms(
        compute_s=hlo_flops / (chips * hw.peak_flops),
        memory_s=hlo_bytes / (chips * hw.hbm_bandwidth),
        collective_s=collective_bytes / (chips * ici_links * hw.ici_bandwidth),
    )
