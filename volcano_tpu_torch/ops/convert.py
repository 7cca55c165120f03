"""Host arrays -> the port's torch tensors.

``to_torch_arrays`` turns a flatten's numpy arrays (``SnapshotArrays``
columns, or the same dict as produced by any other flatten of the same
snapshot) into tensors on one device; ``to_torch_params`` does the same for
the solver's score-parameter dict. Both keep the host dtypes (float32,
int32, bool): index tensors are widened to int64 where the solver gathers
or scatters with them, not here.

Device rule shared by every entry point of the package: ``device=None``
means the CUDA device and raises when there is none. The host is used only
when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the host")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _to_tensor(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    # from_numpy shares memory with the host buffer (flatten buffers are
    # rewritten in place by the next flatten), so copy on a CPU target
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, copy=device.type == "cpu")


def to_torch_arrays(np_dict: Mapping[str, object],
                    device=None) -> Dict[str, torch.Tensor]:
    """Solver input arrays as tensors on ``device`` (float32 / int32 /
    bool, as the flatten made them)."""
    dev = resolve_device(device)
    return {k: _to_tensor(v, dev) for k, v in np_dict.items()}


def to_torch_params(np_params: Mapping[str, object],
                    device=None) -> Dict[str, torch.Tensor]:
    """The score-parameter dict (scalar weights, ``binpack_res_weights``
    [R], ``node_static`` [N]) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: (v.to(dev, torch.float32) if isinstance(v, torch.Tensor)
                else _to_tensor(np.asarray(v, dtype=np.float32), dev))
            for k, v in np_params.items()}
