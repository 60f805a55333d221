"""Elastic re-mesh: rebuild the mesh from surviving ranks and re-shard the
state (the JAX package's ``ft/elastic.py``, on ``DeviceMesh`` and DTensor).

Losing a host means either waiting for a hot spare or shrinking the
data-parallel extent.  ``plan_elastic_mesh`` picks the largest (data,
model) grid that (a) fits the healthy-rank count, (b) keeps the 'model'
extent unchanged (the tensor-parallel degree is baked into weight
shards), and (c) keeps the global batch divisible.  ``reshard`` moves live
DTensors onto the new mesh with no checkpoint round trip.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import sharding as sh


def plan_elastic_mesh(n_healthy: int, *, model_degree: int,
                      global_batch: int) -> Optional[tuple]:
    """Returns (data_degree, model_degree) or None if no valid grid exists."""
    if n_healthy < model_degree:
        return None
    data = n_healthy // model_degree
    while data >= 1:
        if global_batch % data == 0:
            return (data, model_degree)
        data -= 1
    return None


def make_elastic_mesh(ranks: Sequence[int], data: int, model: int, *,
                      device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the first ``data * model`` of
    ``ranks``.  It creates process groups: every rank of the world calls
    it, also those left out of the mesh."""
    grid = torch.tensor(list(ranks)[: data * model],
                        dtype=torch.int).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of ``mesh``'s."""
    return mesh.get_coordinate() is not None


def reshard(tree: dict, specs: dict, new_mesh: DeviceMesh) -> dict:
    """{name: DTensor} -> the same values laid out by ``specs`` on
    ``new_mesh``: each leaf is gathered whole on its old mesh (every rank of
    the old mesh calls this), then each rank of the new mesh keeps its
    chunk.  A rank outside the new mesh gets None for every leaf."""
    keep = in_mesh(new_mesh)
    out = {}
    for name, x in tree.items():
        whole = sh.full(x)
        out[name] = sh.distribute(whole, specs[name], new_mesh) if keep \
            else None
    return out
