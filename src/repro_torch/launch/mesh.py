"""Mesh definitions (the JAX package's ``launch/mesh.py``) as
``torch.distributed`` ``DeviceMesh``es over the process group's world.

Kept as functions (never module-level constants) so that importing this
module touches no process group.  The production target keeps the JAX
package's device counts, 256 and, with a leading pure-DP 'pod' dim, 512,
with a 'model' extent of the 8 GPUs of one H100 NVLink node, so that
tensor parallelism stays inside a node: (32, 8) and (2, 32, 8), where the
JAX package's TPU v5e pod is (16, 16).

``fake_mesh`` builds a mesh of any size, the production ones
(``fake_mesh(*production_mesh_shape())``) among them, in one process over
a ``fake`` process group (no communication): the dry run's
(``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

GPUS_PER_NODE = 8


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, dim names) of the production mesh."""
    if multi_pod:
        return (2, 32, GPUS_PER_NODE), ("pod", "data", "model")
    return (32, GPUS_PER_NODE), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape, names = production_mesh_shape(multi_pod=multi_pod)
    return init_device_mesh("cuda", shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, *, pod: int = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh, or with ``pod`` a (pod, data, model) one,
    over every rank of the process group's world (the product must equal
    the world size)."""
    if pod is None:
        return init_device_mesh(device_type, (data, model),
                                mesh_dim_names=("data", "model"))
    return init_device_mesh(device_type, (pod, data, model),
                            mesh_dim_names=("pod", "data", "model"))


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` over a ``fake`` process group of that
    many ranks, this process rank 0 of it: no other rank exists and the
    group's collectives return at once, moving nothing.  The group is
    process-wide state, made on entry and destroyed on exit, so only a
    process of its own (the dry run's) should enter; entering while a
    process group runs raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already running "
                           "in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()
