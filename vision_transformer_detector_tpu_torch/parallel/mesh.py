"""The mesh over ('data', 'model') axes, on ``torch.distributed``.

Counterpart of vision_transformer_detector_tpu/parallel/mesh.py
(``create_mesh``, ``DATA_AXIS``, ``MODEL_AXIS``). One process is one
position of the mesh: ``create_mesh`` lays the initialised process group's
ranks out row-major as a ``DeviceMesh`` of shape (data, model) with those
axis names, and ``axis_size``/``axis_index``/``axis_group`` give a rank
its place and the group of each axis. The batch is sharded over 'data'
(rank order is batch order). The 'model' axis carries one thing at a
time (``model_axis_role``): the tokens under ``sequence_sharding`` (split
once, models/vit_detector.py) or ``ring_attention`` (the ring,
kernels/ring_attention.py), with the parameters replicated over it;
otherwise tensor parallelism, with the parameters placed as JAX's
``param_shardings`` places them (``kernel_axis``, ``param_placements``):
``shard_params`` cuts a full model to this rank's slices,
``gather_params`` joins them again. JAX shards the parameters in the
first two cases too; the function is the same, only the memory a rank
holds differs.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
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


def model_axis_role(mesh, config) -> Optional[str]:
    """What the 'model' axis carries for ``config``: None on an axis of
    one, "sequence" under ``sequence_sharding`` (its global attention on
    the ring under ``ring_attention`` as well), "ring" under
    ``ring_attention`` alone, else "tensor" (tensor parallelism)."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return None
    if config.sequence_sharding:
        return "sequence"
    if config.ring_attention:
        return "ring"
    return "tensor"


def kernel_axis(name: str, shape, model_size: int) -> Optional[int]:
    """The axis of parameter ``name`` (a ``save_params_npz`` path, "/" or
    "." joined) that tensor parallelism splits over a model axis of
    ``model_size``, or None (replicated): JAX's ``_kernel_spec`` and
    ``_divisible``. The attention q/k/v kernels (D, H, K) split on heads,
    the out kernel (H, K, D) on its head axis (a row-parallel pair), the
    ``mlp`` and ``head_mlp`` kernels column-parallel (axis 1) at an even
    index and row-parallel (axis 0) at an odd one; everything else is
    replicated, and so is a kernel whose split axis ``model_size`` does
    not divide."""
    parts = name.replace(".", "/").split("/")
    axis = None
    if model_size > 1 and parts[-1] == "kernel":
        if "mha" in parts:
            axis = 0 if "out" in parts else 1
        elif "mlp" in parts or "head_mlp" in parts:
            try:
                index = int(parts[-2])
            except ValueError:
                index = 0
            axis = 1 if index % 2 == 0 else 0
    if axis is not None and shape[axis] % model_size:
        return None
    return axis


def param_placements(named_shapes: Iterable[Tuple[str, tuple]],
                     model_size: int) -> Dict[str, Optional[int]]:
    """``kernel_axis`` of every (name, full shape)."""
    return {name: kernel_axis(name, tuple(shape), model_size)
            for name, shape in named_shapes}


def shard_layout(model: torch.nn.Module, mesh) -> Dict[str, tuple]:
    """Per parameter of ``model`` that tensor parallelism splits on
    ``mesh``: ``(full shape, axis, first index of this rank's slice)``
    (full shapes from its config, so a sharded model reads the same);
    empty unless the mesh's 'model' axis carries tensor parallelism (an
    int8-quantized model stays whole: JAX's placements replicate its
    codes)."""
    from ..kernels.quantization import is_quantized
    from ..models.vit_detector import full_shapes

    if (model_axis_role(mesh, model.config) != "tensor"
            or is_quantized(model.linear_projection)):
        return {}
    size, index = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    shapes = full_shapes(model.config,
                         model.encoder[0].mha.query.kernel.shape[-1]
                         if len(model.encoder) else None)
    return {name: (shape, axis, index * shape[axis] // size)
            for (name, shape), axis in zip(
                shapes, param_placements(shapes, size).values())
            if axis is not None}


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Cut ``model``'s full parameters, in place, to this rank's slices
    along their tensor-parallel axes (the same Parameter objects, smaller
    data); a no-op unless the mesh's 'model' axis carries tensor
    parallelism for the model's config."""
    params = dict(model.named_parameters())
    full = {name: params[name] for name in shard_layout(model, mesh)}
    for name, part in slice_tensors(full, model, mesh).items():
        params[name].data = part
    return model


def gather_tensors(tensors: Dict[str, torch.Tensor], model, mesh
                   ) -> Dict[str, torch.Tensor]:
    """Full-shape copies of a dict of ``model``'s parameter-shaped tensors
    (the parameters themselves, or Adam moments), each shard joined over
    the 'model' axis along its tensor-parallel axis (every rank gets
    them; one all-gather each); replicated ones as they are."""
    from . import collectives

    layout = shard_layout(model, mesh)
    group = axis_group(mesh, MODEL_AXIS)
    return {name: (collectives.all_gather_cat(t.detach(), layout[name][1],
                                              group)
                   if name in layout else t.detach())
            for name, t in tensors.items()}


def slice_tensors(tensors: Dict[str, torch.Tensor], model, mesh
                  ) -> Dict[str, torch.Tensor]:
    """This rank's slices of full-shape tensors named as ``model``'s
    parameters (the inverse of ``gather_tensors``)."""
    layout = shard_layout(model, mesh)
    size = axis_size(mesh, MODEL_AXIS)
    out = {}
    for name, t in tensors.items():
        if name in layout:
            _, axis, first = layout[name]
            t = t.detach().narrow(axis, first,
                                  t.shape[axis] // size).contiguous()
        out[name] = t
    return out


def gather_params(model: torch.nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The full state dict of a sharded ``model`` under its
    ``save_params_npz`` names (dots for slashes), on every rank."""
    return gather_tensors(dict(model.state_dict()), model, mesh)
