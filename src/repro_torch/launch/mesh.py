"""Mesh builders, the counterpart of ``repro.launch.mesh``: functions, so
importing this module never touches a process group.

The design.  The reference lays every tensor out with a ``PartitionSpec``
and lets GSPMD place the collectives.  The port keeps the specs as data
(``models.common.P``, leaf for leaf the reference's ``param_specs``) and
runs them as ``torch.distributed.tensor`` DTensors over a ``DeviceMesh``
whose axes carry the reference's names: ``placements(spec, mesh)`` maps a
spec (a mesh axis per tensor dimension) onto DTensor placements (a tensor
dimension per mesh axis), DTensor's sharding propagation stands in for
GSPMD's, and ``Dist.wsc`` is a ``redistribute``.  Hand-written kernels take
plain tensors, so K2's attention and the expert-parallel MoE body run on
each shard's local tensors through ``local_map``, the port's
``shard_map``.  FSDP2 (``fully_shard``) and ``parallelize_module`` are
ruled out: both need ``nn.Module``s, and the model zoo is functions over
dicts of tensors.  The dry-run builds the same program over a fake process
group of 256 or 512 ranks (``launch/dryrun.py``).

Both builders need ``torch.distributed`` initialised with a world of the
mesh's size; ``device_type`` is "cuda" on the card, "cpu" for gloo and for
the dry-run's fake group.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 (one pod, 256 devices) or 2x16x16 (two pods, 512 devices)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A (data, model) mesh over the processes of the group; ``data`` is cut
    to what the world holds, as the reference cuts it to its devices."""
    from torch.distributed.device_mesh import init_device_mesh
    n = tdist.get_world_size()
    data = min(data, n // model) or 1
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def batch_axes_of(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def shard_tree(tree, specs, mesh):
    """A dict tree of whole tensors as DTensors laid out by ``specs`` (the
    same tree of ``P``).  Every process holds the same whole tensors; each
    keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.common import placements
    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], specs[k], mesh) for k in tree}
    return distribute_tensor(tree, mesh, placements(specs, mesh),
                             src_data_rank=None)


def full_tree(tree):
    """A dict tree of DTensors gathered whole on every process (collective:
    every process of the mesh calls it); plain tensors pass."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if hasattr(tree, "full_tensor") else tree

