"""What the CUDA device offers, and whether a dense pair shape fits it.

The counterpart of ``versalignlib_tpu/utils/capabilities.py``: the analogue
of the reference's CPUID gate on the AVX backend (versalignUtil.cpp:78-181).
The fit test delegates to the kernels' own memory plans, as the JAX gate
delegates to its kernels' VMEM plans.
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess

import torch


@dataclasses.dataclass(frozen=True)
class DeviceCapabilities:
    name: str
    sm_count: int
    memory_bytes: int
    #: "<watts> W" as nvidia-smi reports it; None where nvidia-smi is absent
    power_limit: str | None

    def dense_fits(self, m: int, n: int, mode: str = "align",
                   affine: bool = False) -> bool:
        """Whether one warp of 32 pairs of m x n, the smallest batch a
        kernel launch covers, fits the device memory under the kernels' own
        plans (``mode`` "score" or "align"; ``affine`` for Gotoh gaps)."""
        if mode == "score":
            from versalignlib_tpu_torch.ops.cuda_score import score_mem_plan

            return score_mem_plan(m, n, 32, affine) <= self.memory_bytes
        from versalignlib_tpu_torch.ops.cuda_align import align_mem_plan

        return align_mem_plan(m, n, 32, affine) <= self.memory_bytes


def _power_limit(index: int) -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


@functools.lru_cache(maxsize=None)
def probe(index: int = 0) -> DeviceCapabilities:
    """Capabilities of CUDA device ``index``; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    props = torch.cuda.get_device_properties(index)
    return DeviceCapabilities(
        name=props.name,
        sm_count=props.multi_processor_count,
        memory_bytes=props.total_memory,
        power_limit=_power_limit(index),
    )
