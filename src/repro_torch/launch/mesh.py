"""Device meshes for the single-controller sharded dispatch.

Port of the reference's ``launch/mesh.py``.  The reference drives a
``jax.sharding.Mesh`` from one Python process; the PyTorch counterpart is
:class:`DeviceMesh`, a named grid of ``torch.device`` objects that the same
process holds.  The sharded substrate launches each shard's GEMM on the
shard's device, one after another, so nothing here starts a process
group: there are no ranks, ports or environment variables.

**Logical devices.**  :func:`devices` is the port's ``jax.devices()``:
the physical devices of the default platform (every card, else the
CPU), unless :func:`host_devices` fans the process out to ``N``
*logical* devices laid round-robin over the physical devices of one
type — ``N`` x ``cpu`` on the CPU, ``N`` x ``cuda:0`` on one card,
``cuda:i`` on a host with more cards.  It is the counterpart of the
reference's ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` (the
serve CLI's ``--host-devices``), scoped to a ``with`` block.

**Meta devices** (dry runs only): ``host_devices(512, "meta")`` gives 512
logical ``meta`` devices, the counterpart of the reference dry run's 512
host devices.  A step driven over them allocates nothing and computes
nothing; ``roofline.trace`` counts what it dispatches.  No card is needed
and none is replaced: the serving and training entry points still
resolve their device through ``kernels.runtime.resolve_device``, which
refuses ``meta``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device

# the logical devices of the active host_devices scope (None: physical)
_HOST_DEVICES: contextvars.ContextVar[Optional[Tuple[torch.device, ...]]] = \
    contextvars.ContextVar("repro_torch_host_devices", default=None)


class DeviceMesh:
    """A named grid of devices: ``devices`` is an ndarray of
    ``torch.device`` shaped by the axes, ``axis_names`` their names and
    ``shape`` the axis name -> size map (``dict(mesh.shape)`` reads it, as
    of a JAX mesh).  The same device may appear at several coordinates
    (logical devices on one card).  ``ids`` holds each coordinate's
    logical device number (its index in :func:`devices`; default the
    row-major order from 0), which tells logical devices apart where they
    share a ``torch.device``."""

    def __init__(self, devices: np.ndarray, axis_names, ids=None):
        self.devices = devices
        self.ids = (np.arange(devices.size).reshape(devices.shape)
                    if ids is None else ids)
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, coord: Dict[str, int]) -> torch.device:
        """The device at ``coord`` (axis name -> index; absent axes 0)."""
        return self.devices[tuple(coord.get(a, 0) for a in self.axis_names)]

    def device_id(self, coord: Dict[str, int]) -> int:
        """The logical device number at ``coord`` (absent axes 0)."""
        return int(self.ids[tuple(coord.get(a, 0) for a in self.axis_names)])

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"DeviceMesh({axes}; {sorted({str(d) for d in self.devices.flat})})"


def physical_devices(kind: Optional[str] = None):
    """The physical devices of ``kind`` ("cuda", "cpu" or "meta"; None:
    every card when one is present, else the CPU).  Asking for "cuda"
    without a card raises (``kernels.runtime.resolve_device``)."""
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "meta":
        return [torch.device("meta")]
    if resolve_device(kind).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def fan_out(n: int, device=None) -> Tuple[torch.device, ...]:
    """``n`` logical devices laid round-robin over the physical devices of
    ``device``'s type (None: the card; "meta": the dry run's)."""
    if n < 1:
        raise ValueError(f"host devices must be >= 1, got {n}")
    kind = ("meta" if torch.device(device or "cuda").type == "meta"
            else resolve_device(device).type)
    phys = physical_devices(kind)
    return tuple(phys[i % len(phys)] for i in range(n))


def devices():
    """The devices meshes are built over (the reference's
    ``jax.devices()``): the active :func:`host_devices` fan-out, else the
    physical devices."""
    fan = _HOST_DEVICES.get()
    return list(fan) if fan is not None else physical_devices()


@contextlib.contextmanager
def host_devices(n: int, device=None):
    """Inside, :func:`devices` is ``n`` logical devices over the physical
    devices of ``device``'s type (:func:`fan_out`)."""
    token = _HOST_DEVICES.set(fan_out(n, device))
    try:
        yield devices()
    finally:
        _HOST_DEVICES.reset(token)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``.  Raises
    unless that many devices exist."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = devices()
    need = int(np.prod(shape))
    if len(devs) < need:
        raise ValueError(
            f"production mesh {dict(zip(axes, shape))} needs {need} "
            f"devices but only {len(devs)} exist")
    return DeviceMesh(_grid(devs[:need], shape), axes)


def _grid(devs, shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   strict: bool = False) -> DeviceMesh:
    """(data, model) mesh over whatever devices exist (tests / smoke runs).

    Degenerate requests clamp to a valid mesh: each axis size is at least 1
    and the product never exceeds the device count — the mesh uses the
    first ``data * model`` devices.  ``strict=True`` raises instead when
    the requested shape does not fit, with the fan-out hint (the sharded
    dispatch wants the exact mesh it planned for, not a silently clamped
    one)."""
    devs = devices()
    n = len(devs)
    if strict:
        if data < 1 or model < 1:
            raise ValueError(
                f"mesh axis sizes must be >= 1, got (data={data}, "
                f"model={model})")
        if data * model > n:
            raise ValueError(
                f"mesh (data={data}, model={model}) needs {data * model} "
                f"devices but only {n} exist; fan the host out to N "
                f"logical devices with repro_torch.launch.mesh."
                f"host_devices(N) (or pass --host-devices N to "
                f"repro_torch.launch.serve)")
    data = max(1, min(data, n))
    model = max(1, min(model, n // data))
    return DeviceMesh(_grid(devs[:data * model], (data, model)),
                      ("data", "model"))


def pod_mesh(pod: int, data: int, model: int, offset: int) -> DeviceMesh:
    """A ("pod", "data", "model") mesh over the device window ``[offset,
    offset + pod * data * model)`` — a disaggregated role's slice of the
    host (prefill pods at offset 0, decode pods after them).  Raises when
    the window runs past the devices."""
    devs = devices()
    need = offset + pod * data * model
    if len(devs) < need:
        raise ValueError(
            f"pod mesh (pod={pod}, data={data}, model={model}) at "
            f"pod_offset={offset} needs {need} devices, host has "
            f"{len(devs)}; fan the host out with repro_torch.launch.mesh."
            f"host_devices({need}) (--host-devices {need})")
    shape = (pod, data, model)
    return DeviceMesh(_grid(devs[offset:need], shape),
                      ("pod", "data", "model"),
                      ids=np.arange(offset, need).reshape(shape))
