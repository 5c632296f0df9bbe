"""Production mesh builders.

Counterpart of src/repro/launch/mesh.py, over ``torch.distributed``: each
builder returns a ``DeviceMesh`` with the reference's shape and axis names
over the process group the caller has initialised (the ``"fake"`` backend
for the dry-run, gloo for tests and for several ranks of one card), whose
world size must be the mesh's size. Functions, not module constants, so
importing this module touches no process group.
"""
from __future__ import annotations

import numpy as np


def _mesh(shape, axes):
    """A ``cpu`` DeviceMesh: the port's collectives are c10d's on the
    mesh's groups, which take CUDA tensors over gloo as well."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False):
    return (((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else ((16, 16), ("data", "model")))


def tiny_shape(multi_pod: bool = False):
    return (((2, 2, 2), ("pod", "data", "model")) if multi_pod
            else ((2, 4), ("data", "model")))


def make_production_mesh(*, multi_pod: bool = False):
    shape, axes = production_shape(multi_pod)
    return _mesh(shape, axes)


def make_tiny_mesh(*, multi_pod: bool = False):
    """Reduced mesh for CI-sized runs (a world of 8)."""
    shape, axes = tiny_shape(multi_pod)
    return _mesh(shape, axes)


def make_partition_meshes(n_contexts: int, oversubscription: float = 1.0,
                          *, multi_pod: bool = False):
    """DARIS spatial partitioning: split the pod's data axis into
    ``n_contexts`` (possibly overlapping) sub-meshes -- the analogue of MPS
    contexts with SM oversubscription (Eq. 9).

    Returns a list of rank arrays (rows of the data axis per context), the
    ranks of the production mesh laid out as the reference's devices are.
    Chip allocation follows Eq. 9 with ceil_even on the row count; when
    OS > 1 the wrap-around allocation makes neighbouring contexts share
    rows."""
    shape, _ = production_shape(multi_pod)
    devs = np.arange(int(np.prod(shape))).reshape(shape)
    if multi_pod:
        devs = devs.reshape(-1, *devs.shape[2:])   # fold pods into rows
    n_rows = devs.shape[0]
    rows_per_ctx = int(np.ceil(oversubscription * n_rows / n_contexts))
    rows_per_ctx += rows_per_ctx % 2               # ceil_even (Eq. 9)
    rows_per_ctx = max(2, min(rows_per_ctx, n_rows))
    out = []
    stride = n_rows / n_contexts
    for k in range(n_contexts):
        start = int(round(k * stride)) % n_rows
        rows = [(start + i) % n_rows for i in range(rows_per_ctx)]
        out.append(devs[rows])
    return out
