"""What the CUDA device offers, and whether a dense pair shape fits it.

The counterpart of ``versalignlib_tpu/utils/capabilities.py``: the analogue
of the reference's CPUID gate on the AVX backend (versalignUtil.cpp:78-181).
The fit tests delegate to the kernels' own memory plans, as the JAX gates
delegate to their kernels' VMEM plans; the one-vs-many gate
(:func:`check_search_budget`) and the banded gate
(:func:`check_banded_budget`) hold a launch's plan to the free memory.
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
        """Whether the smallest batch of pairs of m x n that a kernel launch
        covers fits the device memory under the kernels' own plans: one block
        of 8 pairs for the score kernel (``mode`` "score"), one warp of 32
        for the fills ("align"); ``affine`` for Gotoh gaps."""
        if mode == "score":
            from versalignlib_tpu_torch.ops.cuda_score import score_mem_plan

            return score_mem_plan(m, n, 8, affine) <= self.memory_bytes
        from versalignlib_tpu_torch.ops.cuda_align import align_mem_plan

        return align_mem_plan(m, n, 32, affine) <= self.memory_bytes


def free_device_bytes(device: torch.device) -> int:
    """Bytes a new allocation on ``device`` can take: what CUDA
    reports free plus what PyTorch's caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + _cached_spare_bytes(device)


def _cached_spare_bytes(device: torch.device) -> int:
    """What PyTorch's caching allocator holds unused on ``device``."""
    return torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def _fits(need: int, device: torch.device) -> bool:
    """Whether ``need`` bytes fit in :func:`free_device_bytes`. The
    allocator's unused bytes are looked at first: where they hold ``need``,
    as they do once a repeated launch has run, CUDA's free-memory
    query (a millisecond or more on the host, the card idle) is skipped."""
    return need <= _cached_spare_bytes(device) or need <= free_device_bytes(device)


def check_search_budget(m: int, n: int, pairs: int, affine: bool,
                        device: torch.device) -> None:
    """Refuse a one-vs-many launch of ``pairs`` pairs of m x n whose
    ``search_mem_plan`` exceeds the free memory of ``device``, with
    guidance, instead of running out of memory (the counterpart of
    ``search._check_dense_budget``). Nothing to check off the card."""
    if device.type != "cuda":
        return
    from versalignlib_tpu_torch.ops.cuda_search import search_mem_plan

    need = search_mem_plan(n, pairs, affine, m)
    if not _fits(need, device):
        free = free_device_bytes(device)
        raise ValueError(
            f"dense search kernel needs {need / 2**20:.0f}MB of device memory "
            f"for {pairs} {m}x{n} sequence pairs; {device} has "
            f"{free / 2**20:.0f}MB free. Long pairs belong on the banded path "
            "(models.banded_smith_waterman / --band); for reference mapping "
            "use a smaller --window; or lower max_pairs.")


def check_banded_budget(plan_bytes: int, device: torch.device) -> None:
    """Refuse a banded launch whose memory plan (``cuda_banded
    .banded_mem_plan``) exceeds the free memory of ``device``, instead of
    running out of memory. Nothing to check off the card."""
    if device.type != "cuda":
        return
    if not _fits(plan_bytes, device):
        free = free_device_bytes(device)
        raise ValueError(
            f"banded kernel needs {plan_bytes / 2**20:.0f}MB of device memory; "
            f"{device} has {free / 2**20:.0f}MB free. Align fewer pairs per "
            "call (chunk_pairs) or use a narrower band.")


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
