"""A single-controller device mesh and the collectives the sharded solvers
use.

The JAX package runs its sharded solvers as one ``shard_map`` program over
a ``Mesh`` of devices, all driven from one process. The port keeps that
shape: a ``Mesh`` is an ordered tuple of ``torch.device``s, one per shard,
and the solver is one Python loop that works on each shard's tensors on
that shard's device. A mesh may name one device several times (D virtual
shards on ``cpu``, or on the one card of a one-GPU host); on a host with
several cards the same code runs over distinct devices.

The collectives are plain functions over a list of per-shard tensors (one
per shard, in shard order). Each returns its result on the device that
asked for it; ``.to(device, non_blocking=True)`` is a no-op for a tensor
already there, so on a mesh of one repeated device nothing is copied.
``calls`` counts the collective calls by kind: a D=1 solve makes none (the
counterpart of the JAX package's collective-free D=1 program).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import torch


class Mesh:
    """An ordered tuple of devices, one per shard; a device may repeat."""

    __slots__ = ("devices",)

    def __init__(self, devices: Iterable):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in first-seen order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass the mesh's "
                           "devices (e.g. ['cpu'] * 4) to run on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Sequence = None) -> Mesh:
    """A mesh over ``devices`` (every CUDA device when None; raises when
    there is none)."""
    return Mesh(_cuda_devices() if devices is None else devices)


def arena_mesh(devices: Sequence = None, max_devices: int = 0) -> Mesh:
    """A mesh over the largest power-of-two prefix of ``devices`` (every
    CUDA device when None), at most 8: the padded node axis is a multiple
    of 8 (``ops.arrays.bucket``), so any such D divides it evenly. One card
    gives D=1."""
    devices = list(_cuda_devices() if devices is None else devices)
    if max_devices:
        devices = devices[:max_devices]
    d = 1
    while d * 2 <= len(devices) and d < 8:
        d *= 2
    return Mesh(devices[:d])


#: collective calls by kind since the counts were last set to 0
calls: Dict[str, int] = {"all_gather": 0, "all_gather_tiled": 0,
                         "psum": 0, "pmax": 0}


def _gather(xs, device) -> list:
    return [x.to(device, non_blocking=True) for x in xs]


def all_gather(xs, device) -> torch.Tensor:
    """The per-shard tensors stacked on a new leading axis: [D, ...]."""
    calls["all_gather"] += 1
    return torch.stack(_gather(xs, device))


def all_gather_tiled(xs, device) -> torch.Tensor:
    """The per-shard tensors concatenated along axis 0, in shard order."""
    calls["all_gather_tiled"] += 1
    return torch.cat(_gather(xs, device))


def psum(xs, device) -> torch.Tensor:
    """The elementwise sum over shards, in the shards' dtype."""
    calls["psum"] += 1
    return torch.stack(_gather(xs, device)).sum(dim=0, dtype=xs[0].dtype)


def pmax(xs, device) -> torch.Tensor:
    """The elementwise maximum over shards."""
    calls["pmax"] += 1
    return torch.stack(_gather(xs, device)).amax(dim=0)
