"""The mesh over ('data', 'model') axes, on ``torch.distributed``.

Counterpart of vision_transformer_detector_tpu/parallel/mesh.py
(``create_mesh``, ``DATA_AXIS``, ``MODEL_AXIS``). One process is one
position of the mesh: ``create_mesh`` lays the initialised process group's
ranks out row-major as a ``DeviceMesh`` of shape (data, model) with those
axis names, and ``axis_size``/``axis_index``/``axis_group`` give a rank
its place and the group of each axis. The batch is sharded over 'data'
(rank order is batch order); everything is replicated over 'model',
which only ring attention uses: its token axis is the ring
(kernels/ring_attention.py). Tensor parallelism (the JAX package's
``param_shardings``, Megatron placements of the dense layers) is not
ported, so ``check_mesh_config`` refuses a model axis above 1 without
``ring_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def create_mesh(data: Optional[int] = None, model: int = 1) -> DeviceMesh:
    """Mesh over ('data', 'model') of the initialised process group's
    ranks, row-major. ``data=None`` uses all remaining ranks for data
    parallelism. The DeviceMesh's device type is "cuda" under NCCL, else
    "cpu" (gloo meshes move CUDA tensors through the host,
    parallel/collectives.py)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs an initialised process group "
            "(parallel/data.py:initialize_distributed, or torchrun)")
    n = dist.get_world_size()
    if data is None:
        if n % model != 0:
            raise ValueError(
                f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} available devices")
    device_type = ("cuda" if str(dist.get_backend()).lower() == "nccl"
                   else "cpu")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    """The length of ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    if mesh is None:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of the ranks that share this rank's coordinates
    but for ``axis`` (None without a mesh)."""
    if mesh is None:
        return None
    return mesh.get_group(axis)


def check_mesh_config(mesh, config) -> None:
    """Raise NotImplementedError for a mesh the port cannot run the config
    on: a model axis above 1 is the ring of ``ring_attention`` and
    nothing else, since tensor parallelism is not ported."""
    if axis_size(mesh, MODEL_AXIS) > 1 and not config.ring_attention:
        raise NotImplementedError(
            f"a mesh with model={axis_size(mesh, MODEL_AXIS)} needs "
            "ring_attention: tensor parallelism (the Megatron placements "
            "of the dense layers, param_shardings) is not ported to "
            "PyTorch yet; use model=1 (data parallelism)")
