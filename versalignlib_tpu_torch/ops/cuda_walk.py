"""The traceback walks ``csrc/walk.cu`` (dense: B7 linear, B8 Gotoh) and
``csrc/banded_walk.cu`` (banded: B9 linear, B10 Gotoh) — the counterparts
of ``walk_blocks``, ``walk_blocks_affine``, ``walk_blocks_banded`` and
``walk_blocks_banded_affine`` in ``versalignlib_tpu/ops/walk.py``.

:func:`walk` and :func:`banded_walk` take a fill's outputs where the fill
left them and return ``(records (B, m), start_r, start_f, scores)``, int32
on the same device. A tensor on the CPU goes to the plain version
(``ops/walk.py``); a CUDA tensor launches the kernel on the current stream,
with no host synchronisation after the fill, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from versalignlib_tpu_torch.ops import walk as plain_walk
from versalignlib_tpu_torch.ops._build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int

#: The dense walk (B7, B8); ``WALK_KERNEL.launches`` counts its launches.
WALK_KERNEL = CudaKernel("walk.cu", "val_walk_launch", [_P] * 7 + [_I] * 6 + [_P])

#: The banded walk (B9, B10), with its own launch count.
BANDED_WALK_KERNEL = CudaKernel(
    "banded_walk.cu", "val_banded_walk_launch", [_P] * 8 + [_I] * 7 + [_P])


def resolve_device_walk(device_walk: bool | None, device: torch.device) -> bool:
    """Whether to walk on the device: ``None`` walks there on a CUDA device
    and on the host on the CPU, as the JAX package walks on the device in
    compiled runs and on the host in interpret mode; True and False are
    kept as given (True on the CPU runs the plain walk)."""
    if device_walk is None:
        return torch.device(device).type == "cuda"
    return bool(device_walk)


def _addr(x):
    return None if x is None else x.data_ptr()


def _ints(*xs: torch.Tensor | None) -> list:
    """The (B,) int32 inputs, contiguous; None stays None."""
    return [None if x is None else x.to(torch.int32).contiguous() for x in xs]


def _outputs(b: int, m: int, dev: torch.device):
    records = torch.empty((b, m), dtype=torch.int32, device=dev)
    ends = torch.empty((3, b), dtype=torch.int32, device=dev)
    return records, ends


def walk(ptr: torch.Tensor, aux: torch.Tensor, hsel: torch.Tensor | None,
         mrp: torch.Tensor, mxp: torch.Tensor, n: int, local: bool, affine: bool):
    """Dense walk over a fill's ptr (B, m, ceil(n/16)) of 2-bit codes, or
    with ``affine`` (B, m, ceil(n/8)) of 4-bit Gotoh codes, its aux (B, 4)
    and (NW) hsel (B, n+1); mrp and mxp (B,) are each pair's last valid read
    row and ref column (NW only)."""
    b, m, nc = ptr.shape
    if nc != -(-n // (8 if affine else 16)) or aux.shape != (b, 4):
        raise ValueError(f"walk inputs {tuple(ptr.shape)}, {tuple(aux.shape)} do not fit "
                         f"{b} pairs of {m}x{n}")
    if not local and (hsel is None or hsel.shape != (b, n + 1)):
        raise ValueError("an NW walk needs hsel (B, n+1)")
    if ptr.device.type == "cpu":
        fn = plain_walk.walk_dense_affine if affine else plain_walk.walk_dense
        return fn(ptr, aux, hsel, mrp, mxp, n, local)
    dev = ptr.device
    records, ends = _outputs(b, m, dev)
    if b == 0:
        return records, ends[0], ends[1], ends[2]
    ptr, aux, hsel = (None if x is None else x.contiguous() for x in (ptr, aux, hsel))
    mrp, mxp = _ints(mrp, mxp)
    WALK_KERNEL.launch(
        ptr.data_ptr(), aux.data_ptr(), _addr(hsel), _addr(mrp), _addr(mxp),
        records.data_ptr(), ends.data_ptr(), b, m, n, nc, int(local), int(affine),
        torch.cuda.current_stream(dev).cuda_stream)
    return records, ends[0], ends[1], ends[2]


def banded_walk(ptr: torch.Tensor, best: torch.Tensor | None, keep: torch.Tensor | None,
                mrp: torch.Tensor, mxp: torch.Tensor, offsets, n: int, band: int,
                local: bool, affine: bool):
    """Banded walk over the banded fill's band-relative ptr (B, m,
    ceil(band/8)), its best (B, 4) for SW or keep (B, band) for NW, and the
    (m,) band starts ``offsets`` (numpy or a tensor)."""
    b, m, nw = ptr.shape
    if nw != -(-band // 8) or not 1 <= band <= n or len(offsets) != m:
        raise ValueError(f"banded walk inputs {tuple(ptr.shape)} do not fit {b} pairs of "
                         f"{m} rows, n={n}, band={band}, {len(offsets)} band starts")
    if (best if local else keep) is None:
        raise ValueError("a banded walk needs best (SW) or keep (NW)")
    dev = ptr.device
    if not isinstance(offsets, torch.Tensor):
        offsets = torch.from_numpy(np.asarray(offsets, dtype=np.int32))
    offs = offsets.to(dev, torch.int32).contiguous()
    if dev.type == "cpu":
        fn = plain_walk.walk_banded_affine if affine else plain_walk.walk_banded
        return fn(ptr, best, keep, mrp, mxp, offs, n, band, local)
    records, ends = _outputs(b, m, dev)
    if b == 0:
        return records, ends[0], ends[1], ends[2]
    ptr, best, keep = (None if x is None else x.contiguous() for x in (ptr, best, keep))
    mrp, mxp = _ints(mrp, mxp)
    BANDED_WALK_KERNEL.launch(
        ptr.data_ptr(), _addr(best), _addr(keep), _addr(mrp), _addr(mxp), offs.data_ptr(),
        records.data_ptr(), ends.data_ptr(), b, m, n, band, nw, int(local), int(affine),
        torch.cuda.current_stream(dev).cuda_stream)
    return records, ends[0], ends[1], ends[2]
