"""Device meshes for data-parallel alignment (the port's counterpart of
``versalignlib_tpu/parallel/mesh.py``).

A mesh is an ordered tuple of ``torch.device``s along one ``data`` axis:
shard ``d`` of a batch runs on ``devices[d]``. Pairwise alignment has no
coupling between pairs, so one axis is the whole layout, and the only
communication is the trailing gather of results.
"""

from __future__ import annotations

import dataclasses

import torch

#: Name of the batch-sharding mesh axis.
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: shard ``d`` runs on ``devices[d]``. The
    devices are all CUDA devices or all the CPU; one device may hold
    several shards."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.size}

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"


def make_mesh(n_devices: int | None = None, devices=None,
              device: torch.device | str = "cuda") -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` of ``devices``.

    ``devices`` defaults to every CUDA device of the process, and with no
    card that raises, as the engine does: there is no quiet CPU mesh.
    ``device="cpu"`` asks for ``n_devices`` (default 1) shards on the CPU,
    which run one after another on the plain path; an explicit list such
    as ``[torch.device("cpu")] * 8`` does the same. Asking for more devices
    than are present raises ``ValueError``.
    """
    if devices is None:
        device = torch.device(device)
        if device.type == "cpu":
            devices = [device] * (1 if n_devices is None else n_devices)
        elif device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "make_mesh() needs CUDA devices, and none is available "
                    "(torch.cuda.is_available() is False); pass device='cpu' for "
                    "a mesh of CPU shards")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            raise ValueError(f"unsupported device {device}")
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, only {len(devices)} present")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    kinds = {d.type for d in devices}
    if kinds - {"cuda", "cpu"} or len(kinds) > 1:
        raise ValueError(f"a mesh's devices are all CUDA devices or all the CPU, "
                         f"got {[str(d) for d in devices]}")
    if kinds == {"cuda"}:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh of CUDA devices needs a card, and none is available")
        devices = [torch.device("cuda", torch.cuda.current_device() if d.index is None
                                else d.index) for d in devices]
    return Mesh(tuple(devices))
