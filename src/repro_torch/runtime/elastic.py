"""Elastic scaling: re-plan the mesh and re-shard state on fleet changes.

Port of the reference's ``runtime/elastic.py``.  When hosts die or join,
the launcher rebuilds the largest valid mesh from the survivors and
re-shards: parameters keep their logical specs, so moving to a new mesh
is placing each leaf under the new mesh's :class:`NamedSharding`.  The
data pipeline re-partitions by (host_index, host_count); deterministic
step indexing means no sample is lost or duplicated across the
transition.

On the port's single controller a mesh is a grid of ``torch.device``
views (``launch.mesh``), every leaf lives whole on the mesh's home device
and the sharded dispatch slices blocks at launch
(``kernels.substrate._sharded_gemm``), so :func:`reshard` moves each leaf
to the home device and checks it against its spec, raising where the
reference's ``jax.device_put`` under that ``NamedSharding`` raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch import tree as tree_lib
from repro_torch.kernels.runtime import to_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.parallel import sharding as shd


@dataclass(frozen=True)
class ElasticState:
    n_devices: int
    mesh_shape: tuple
    axis_names: tuple


def largest_mesh_shape(n_devices: int, model_parallel: int) -> tuple:
    """Largest (data, model) grid with fixed TP degree."""
    model = min(model_parallel, n_devices)
    while n_devices % model:
        model -= 1
    return (n_devices // model, model)


def replan_mesh(devices=None, model_parallel: int = 1):
    """(the largest (data, model) :class:`~repro_torch.launch.mesh.DeviceMesh`
    over ``devices`` — default ``launch.mesh.devices()`` — at TP degree
    ``model_parallel`` or the largest below it that divides, its
    :class:`ElasticState`)."""
    devices = list(devices) if devices is not None else mesh_lib.devices()
    n = len(devices)
    data, model = largest_mesh_shape(n, model_parallel)
    grid = np.empty(data * model, dtype=object)
    grid[:] = devices[:data * model]
    mesh = mesh_lib.DeviceMesh(grid.reshape(data, model), ("data", "model"))
    return mesh, ElasticState(n, (data, model), ("data", "model"))


def check_spec(shape, spec, mesh) -> None:
    """Raise ``ValueError`` where ``jax.device_put`` raises for a value of
    ``shape`` under ``NamedSharding(mesh, spec)``:

    * the spec names an axis the mesh lacks;
    * the spec maps one mesh axis to two dims (the reference raises
      ``DuplicateSpecError``);
    * the spec has more entries than the value has dims;
    * a dim does not divide by the product of its axes' sizes (uneven
      shards)."""
    axes = [a for e in spec for a in shd._spec_axes(e)]
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"resource axis {a!r} of spec {spec} is not "
                             f"found in mesh {mesh.axis_names}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"spec {spec} maps a mesh axis to more than one "
                         f"dimension")
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} is only valid for values of rank at "
                         f"least {len(spec)}, got shape {tuple(shape)}")
    for size, e in zip(shape, spec):
        n = math.prod(mesh.shape[a] for a in shd._spec_axes(e))
        if size % n:
            raise ValueError(f"dimension of size {size} in shape "
                             f"{tuple(shape)} does not divide by {n} under "
                             f"spec {spec}")


def reshard(tree, pspecs, mesh):
    """Move a tree onto ``mesh`` under its logical specs: each leaf (a
    value with a ``shape``) whole to the mesh's home device.  It raises
    ``ValueError`` where the reference's ``jax.device_put`` under the
    leaf's ``NamedSharding`` raises (:func:`check_spec`): a spec naming an
    axis the mesh lacks, one mesh axis on two dims, more spec entries
    than dims, or a dim its axes do not divide."""
    home = mesh.devices.flat[0]
    specs = dict(tree_lib.leaves_with_path(shd.named(pspecs, mesh)))

    def put(path, x):
        if not hasattr(x, "shape"):
            return x
        s = specs[path]
        check_spec(tuple(x.shape), s.spec, s.mesh)
        return to_device(x, home)

    return tree_lib.map_with_path(put, tree)
