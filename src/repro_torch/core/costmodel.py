"""System-level energy/latency model for the psum datapath (paper Sec. IV-B).

Copy of repro.core.costmodel (pure arithmetic, no tensors).

NeuroSim-style accounting at 65 nm / 200 MHz for the psum pipeline:
crossbar MAC -> ADC -> [zero-compress] -> psum buffer -> transfer ->
[zero-skip] -> accumulate.

Analytic structure (bits per psum, adc resolution b, sparsity rho):
    vConv storage/transfer:  b                    bits/psum
    CADC  storage/transfer:  1 (bitmask) + (1-rho)*b   bits/psum
    => reduction = rho - 1/b.   At the paper's ResNet-18 point
    (rho = 0.54, b = 4): 0.54 - 0.25 = 0.29  — the paper's 29.3%. The model
    is exact up to the 0.3% compressor-circuit overhead, which we carry as
    `compress_overhead`.

    vConv accumulation ops:  1/psum (minus one per group, ~1 for large S)
    CADC  accumulation ops:  (1-rho)/psum + skip-check overhead
    => reduction = rho - skip_overhead. Paper: 54% sparsity -> 47.9%
    accumulation saving => skip_overhead = 0.061 accumulation-equivalents
    per psum. Both overheads are calibrated constants (documented fits to
    the paper's synthesis results, like NeuroSim's).

Energy constants are derived from the paper's 65 nm macro (725.4 TOPS/W at
4/2/4b => ~2.76 fJ/op at the macro; psum-path energies set so that psums
account for ~48% of VGG-8 system energy as in Fig. 1a).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from repro_torch.core.sparsity import LayerPsumStats

# ---------------------------------------------------------------------------
# Calibrated constants (65 nm, 200 MHz digital domain; see module docstring)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    # crossbar + ADC (per the macro's 725.4 TOPS/W at 4/2/4b: 1 MAC = 2 ops)
    e_mac_fj: float = 2.76          # fJ / op inside the macro (MAC+ADC amortized)
    # psum digital path, per bit (65 nm SRAM buffer + NoC segment)
    e_buf_rw_fj_bit: float = 45.0   # buffer write+read, fJ/bit
    e_transfer_fj_bit: float = 110.0  # crossbar->accumulator hop, fJ/bit
    # accumulation (b-bit adder op)
    e_accum_fj: float = 320.0       # fJ / accumulation op (4-8b adder+reg)
    # calibrated overheads (fits to paper's 65 nm synthesis @200 MHz)
    compress_overhead: float = 0.003   # frac of vConv buffer+transfer energy
    skip_overhead: float = 0.061       # accumulation-equivalents per psum
    freq_hz: float = 200e6
    # digital throughput assumptions for the latency model
    accum_lanes: int = 256          # parallel accumulators
    transfer_bits_per_cycle: int = 256  # NoC width


DEFAULT_PARAMS = EnergyParams()


@dataclasses.dataclass
class PathCost:
    buffer_pj: float
    transfer_pj: float
    accum_pj: float
    compress_overhead_pj: float
    skip_overhead_pj: float
    accum_cycles: float
    transfer_cycles: float

    @property
    def overhead_pj(self) -> float:
        return self.compress_overhead_pj + self.skip_overhead_pj

    @property
    def psum_pj(self) -> float:
        return self.buffer_pj + self.transfer_pj + self.accum_pj + self.overhead_pj

    @property
    def psum_cycles(self) -> float:
        # buffer + transfer pipelined; accumulation chained after.
        return self.transfer_cycles + self.accum_cycles


def psum_path_cost(
    n_psums: float,
    sparsity: float,
    adc_bits: int,
    *,
    compressed: bool,
    skipped: bool,
    params: EnergyParams = DEFAULT_PARAMS,
) -> PathCost:
    """Energy/latency of the psum pipeline for one inference."""
    b = float(adc_bits)
    if compressed:
        bits_per_psum = 1.0 + (1.0 - sparsity) * b
    else:
        bits_per_psum = b
    total_bits = n_psums * bits_per_psum
    buffer_pj = total_bits * params.e_buf_rw_fj_bit * 1e-3
    transfer_pj = total_bits * params.e_transfer_fj_bit * 1e-3

    accum_ops = n_psums * ((1.0 - sparsity) if skipped else 1.0)
    accum_pj = accum_ops * params.e_accum_fj * 1e-3

    compress_overhead_pj = 0.0
    skip_overhead_pj = 0.0
    if compressed:
        base_bits = n_psums * b
        compress_overhead_pj = (
            params.compress_overhead
            * base_bits
            * (params.e_buf_rw_fj_bit + params.e_transfer_fj_bit)
            * 1e-3
        )
    if skipped:
        skip_overhead_pj = n_psums * params.skip_overhead * params.e_accum_fj * 1e-3

    accum_cycles = accum_ops / params.accum_lanes
    transfer_cycles = total_bits / params.transfer_bits_per_cycle
    return PathCost(
        buffer_pj=buffer_pj,
        transfer_pj=transfer_pj,
        accum_pj=accum_pj,
        compress_overhead_pj=compress_overhead_pj,
        skip_overhead_pj=skip_overhead_pj,
        accum_cycles=accum_cycles,
        transfer_cycles=transfer_cycles,
    )


@dataclasses.dataclass
class SystemReport:
    vconv: PathCost
    cadc: PathCost
    mac_pj: float            # identical for both (same MACs)
    mac_cycles: float

    def reductions(self) -> Dict[str, float]:
        """Overheads are attributed to the pipeline that incurs them:
        compression -> buffer+transfer, skip-check -> accumulation."""
        v, c = self.vconv, self.cadc
        bt_v = v.buffer_pj + v.transfer_pj
        bt_c = c.buffer_pj + c.transfer_pj + c.compress_overhead_pj
        ac_v = v.accum_pj
        ac_c = c.accum_pj + c.skip_overhead_pj
        return {
            "buffer_transfer_reduction": 1.0 - (bt_c / bt_v) if bt_v else 0.0,
            "accum_reduction": 1.0 - (ac_c / ac_v) if ac_v else 0.0,
            "total_psum_energy_reduction": (
                1.0 - c.psum_pj / v.psum_pj if v.psum_pj else 0.0
            ),
            "psum_latency_speedup": (
                v.psum_cycles / c.psum_cycles if c.psum_cycles else float("inf")
            ),
        }


def evaluate_network(
    layers: Sequence[LayerPsumStats],
    *,
    macs: float,
    adc_bits: int = 4,
    params: EnergyParams = DEFAULT_PARAMS,
) -> SystemReport:
    """Full-network vConv vs CADC psum-path comparison (paper Fig. 10).

    `layers` carry per-layer psum counts + sparsities (from sparsity.py);
    `macs` is total multiply-accumulates per inference (for the MAC energy
    baseline that both schemes share).
    """
    part = [s for s in layers if s.partitioned]
    n = float(sum(s.count for s in part))
    # count-weighted sparsities
    rho_cadc = 0.0 if n == 0 else sum(s.count * s.sparsity for s in part) / n
    vconv = psum_path_cost(
        n, 0.0, adc_bits, compressed=False, skipped=False, params=params
    )
    cadcp = psum_path_cost(
        n, rho_cadc, adc_bits, compressed=True, skipped=True, params=params
    )
    mac_pj = macs * 2.0 * params.e_mac_fj * 1e-3  # 1 MAC = 2 ops
    mac_cycles = 0.0  # analog-domain, overlapped with psum pipeline
    return SystemReport(vconv=vconv, cadc=cadcp, mac_pj=mac_pj, mac_cycles=mac_cycles)


# ---------------------------------------------------------------------------
# Macro/system throughput model (paper Table II)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MacroConfig:
    crossbar: int = 256        # 256x256 twin-9T array
    n_macros: int = 16         # system-level macro count (ResNet-18 mapping)
    freq_hz: float = 200e6
    input_bits: int = 4
    # Calibrated so the model reproduces the paper's measured 2.15 TOPS for
    # ResNet-18 (4/2/4b). Real IMC utilization is low: PWM serialization,
    # psum-pipeline stalls, and weight-stationary layer imbalance all bound
    # achieved throughput far below the analog peak.
    utilization: float = 0.0205


def system_tops(cfg: MacroConfig = MacroConfig()) -> float:
    """Peak ops/s: 2 ops/MAC * N^2 MACs/crossbar-activation. PWM multi-bit
    inputs serialize over input_bits cycles of the 1 GHz PWM clock; the
    200 MHz system clock bounds activation rate."""
    macs_per_act = cfg.crossbar * cfg.crossbar
    acts_per_s = cfg.freq_hz / cfg.input_bits
    return 2.0 * macs_per_act * acts_per_s * cfg.n_macros * cfg.utilization / 1e12


def system_tops_w(
    cfg: MacroConfig,
    report: SystemReport,
    macro_tops_w: float = 725.4,
) -> float:
    """System TOPS/W: macro efficiency degraded by the psum-path energy.
    E_total = E_mac * (1 + psum_pj / mac_pj)."""
    if report.mac_pj <= 0:
        return macro_tops_w
    overhead = report.cadc.psum_pj / report.mac_pj
    return macro_tops_w / (1.0 + overhead)


# Published accelerator rows for the Table II comparison benchmark.
TABLE_II_BASELINES: List[Dict[str, object]] = [
    {"name": "JSSC'22 [23]", "tops": 0.20, "tops_w": (1.78, 6.91), "tech_nm": 65},
    {"name": "ISSCC'23 [21]", "tops": 0.12, "tops_w": (10.58, 10.58), "tech_nm": 28},
    {"name": "TCASI'24 [22]", "tops": None, "tops_w": (5.45, 21.82), "tech_nm": 28},
]
