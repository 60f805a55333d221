"""Device-fleet profiles: the analytical spec sheet of every target PM2Lat
can re-anchor its tables onto (paper §III-C "rerun or re-anchor", the
re-anchor path).

A ``DeviceProfile`` is coarser than a calibration: per-dtype peak FLOP/s,
main-memory bandwidth, cache/scratchpad sizes and SM (core) counts — the
quantities the roofline-ratio transfer in ``core/transfer.py`` needs.  Real
per-device tables still come from running ``core/calibrate.py`` on the
device.  A copy of the JAX package's profiles, field for field.

Numbers are vendor datasheet values (dense, no sparsity) for the SXM/top
variants unless noted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.collectives import Interconnect
from repro_torch.core.comm_calibrate import calibrated_interconnect
from repro_torch.core.device import peak_lookup


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    kind: str                     # 'gpu' | 'tpu' | 'cpu'
    peak_flops: Dict[str, float]  # dtype -> FLOP/s (dense)
    hbm_bw: float                 # bytes/s, main-memory bandwidth
    hbm_bytes: int                # main-memory capacity
    l2_bytes: int                 # L2 cache (0 where N/A)
    smem_bytes: int               # shared memory / VMEM per SM (core)
    sm_count: int                 # SMs (GPU) / TensorCores (TPU) / cores (CPU)
    link_bw: float = 0.0          # NVLink / ICI / PCIe per direction, bytes/s
    interconnect: Optional[Interconnect] = None  # α–β spec (core/collectives)
    notes: str = ""

    def peak(self, dtype: str, *, strict: bool | None = None) -> float:
        return peak_lookup(self.peak_flops, dtype,
                           f"DeviceProfile({self.name})", strict)

    def ridge(self, dtype: str) -> float:
        """Arithmetic-intensity knee (FLOP/byte) of this device's roofline:
        ops below it are memory-bound, above it compute-bound."""
        return self.peak(dtype) / self.hbm_bw

    def roofline_throughput(self, ai: float, dtype: str) -> float:
        """Attainable FLOP/s at arithmetic intensity ``ai`` (FLOP/byte)."""
        return min(self.peak(dtype), ai * self.hbm_bw)

    def usable_hbm(self, reserve: float = 0.1) -> float:
        """Memory available to model state + activations: capacity minus a
        ``reserve`` fraction held back for the framework (CUDA context,
        allocator fragmentation, NCCL buffers)."""
        if not 0.0 <= reserve < 1.0:
            raise ValueError(f"reserve must be in [0, 1), got {reserve}")
        return self.hbm_bytes * (1.0 - reserve)

    def calibrated_interconnect(self) -> Interconnect:
        """The interconnect predictions use for this device: the measured
        fit from the comm-calibration artifact when one exists
        (``core/comm_calibrate.py``), else the datasheet ``interconnect``
        field, else ``DEFAULT_INTERCONNECT``.  The datasheet numbers above
        stay what they are — the spec sheet; calibration overlays them."""
        return calibrated_interconnect(self.name)


GiB = 1024 ** 3
MiB = 1024 ** 2
KiB = 1024

A100_80G = DeviceProfile(
    name="a100_80g", kind="gpu",
    peak_flops={"float32": 19.5e12, "tf32": 156e12, "bfloat16": 312e12,
                "float16": 312e12, "int8": 624e12},
    hbm_bw=2039e9, hbm_bytes=80 * GiB,
    l2_bytes=40 * MiB, smem_bytes=164 * KiB, sm_count=108,
    link_bw=600e9 / 2,
    interconnect=Interconnect("nvlink-mesh", link_bw=25e9,
                              link_latency=2.0e-6, links_per_gpu=12),
    notes="A100-SXM4-80GB (GA100); NVLink3: 12 links x 25 GB/s/dir")

# The card the port targets; ``chip_smoke.py`` computes its roofline bounds
# from these peaks and bandwidth.  float32 is the CUDA-core FFMA rate (true
# f32, what the hand kernels and cuBLAS f32 GEMMs run at).
H100_SXM = DeviceProfile(
    name="h100_sxm", kind="gpu",
    peak_flops={"float32": 67e12, "tf32": 494.5e12, "bfloat16": 989e12,
                "float16": 989e12, "fp8": 1979e12, "int8": 1979e12},
    hbm_bw=3350e9, hbm_bytes=80 * GiB,
    l2_bytes=50 * MiB, smem_bytes=228 * KiB, sm_count=132,
    link_bw=900e9 / 2,
    interconnect=Interconnect("nvlink-mesh", link_bw=25e9,
                              link_latency=1.5e-6, links_per_gpu=18),
    notes="H100-SXM5-80GB (GH100); NVLink4: 18 links x 25 GB/s/dir")

V100 = DeviceProfile(
    name="v100", kind="gpu",
    peak_flops={"float32": 15.7e12, "float16": 125e12, "bfloat16": 15.7e12},
    hbm_bw=900e9, hbm_bytes=32 * GiB,
    l2_bytes=6 * MiB, smem_bytes=96 * KiB, sm_count=80,
    link_bw=300e9 / 2,
    interconnect=Interconnect("nvlink-mesh", link_bw=25e9,
                              link_latency=2.5e-6, links_per_gpu=6),
    notes="V100-SXM2-32GB (GV100); no bf16 tensor cores — bf16 ~ fp32 rate; "
          "NVLink2: 6 links x 25 GB/s/dir")

RTX_4090 = DeviceProfile(
    name="rtx_4090", kind="gpu",
    peak_flops={"float32": 82.6e12, "tf32": 82.6e12, "bfloat16": 165.2e12,
                "float16": 165.2e12, "int8": 660.6e12},
    hbm_bw=1008e9, hbm_bytes=24 * GiB,
    l2_bytes=72 * MiB, smem_bytes=100 * KiB, sm_count=128,
    link_bw=32e9,
    interconnect=Interconnect("pcie-tree", link_bw=32e9,
                              link_latency=5.0e-6, links_per_gpu=1),
    notes="GeForce RTX 4090 (AD102), GDDR6X, PCIe 4.0 x16")

L4 = DeviceProfile(
    name="l4", kind="gpu",
    peak_flops={"float32": 30.3e12, "tf32": 60e12, "bfloat16": 121e12,
                "float16": 121e12, "int8": 242e12, "fp8": 242e12},
    hbm_bw=300e9, hbm_bytes=24 * GiB,
    l2_bytes=48 * MiB, smem_bytes=100 * KiB, sm_count=58,
    link_bw=32e9,
    interconnect=Interconnect("pcie-tree", link_bw=32e9,
                              link_latency=5.0e-6, links_per_gpu=1),
    notes="NVIDIA L4 (AD104), GDDR6, PCIe 4.0 x16")

# Google's TPU v5e datasheet (the values the JAX package's DeviceModel
# carries): a transfer target, not a measurement of this port.
TPU_V5E = DeviceProfile(
    name="tpu_v5e", kind="tpu",
    peak_flops={"bfloat16": 197e12, "float32": 98.5e12, "int8": 394e12},
    hbm_bw=819e9, hbm_bytes=16 * 1024 ** 3,
    l2_bytes=0, smem_bytes=128 * 1024 ** 2, sm_count=1,
    link_bw=50e9,
    interconnect=Interconnect("nvlink-mesh", link_bw=50e9,
                              link_latency=1.0e-6, links_per_gpu=4),
    notes="TPU v5e chip; smem is the 128 MiB VMEM; "
          "ICI: 4 links per chip (2D torus), modeled as a mesh")

FLEET = (A100_80G, H100_SXM, V100, RTX_4090, L4, TPU_V5E)
