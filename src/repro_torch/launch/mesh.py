"""Mesh construction for the port's sharded serving (port of
``repro/launch/mesh.py`` and ``hostdev.parse_mesh_shape``).

Functions, not module constants: importing this module touches no process
group and no device.  The caller starts the process group (``torchrun``
on cards, ``launch/serve.py --mesh`` spawning gloo ranks on the CPU); a
mesh then takes every rank of it.
"""
from __future__ import annotations

import math
from typing import Tuple

from ..device import resolve_device

AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")


def parse_mesh_shape(s: str) -> Tuple[int, ...]:
    """"2x2" -> (2, 2); "2x2x2" -> (2, 2, 2).  2 axes = (data, model),
    3 = (pod, data, model)."""
    try:
        dims = tuple(int(x) for x in s.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants DxM (e.g. 2x2), got {s!r}")
    if len(dims) not in (2, 3) or any(d <= 0 for d in dims):
        raise ValueError(f"--mesh wants 2 or 3 positive dims, got {s!r}")
    return dims


def make_debug_mesh(shape=(2, 2), device="cuda", axes=None):
    """A ``DeviceMesh`` of ``shape`` over the initialised process group,
    its dims named like the reference's axes: 2 dims ("data", "model"), 3
    ("pod", "data", "model"), so that every sharding rule applies.
    ``device``: the card by default ("cuda": NCCL, one card a rank; raises
    without one, as every entry point of the port does), or "cpu" (gloo)
    when the caller asks for it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(shape)
    if axes is None:
        axes = AXES_3D if len(shape) == 3 else AXES_2D
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs an initialised process group of {need} "
            f"ranks (torchrun on cards; launch/serve.py --mesh spawns gloo "
            f"ranks on the CPU)")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks but the process group has "
            f"{world}: start {need} ranks, or pick a mesh whose dims "
            f"multiply to {world}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh on the initialised process group:
    (16, 16) over ("data", "model"), 256 ranks, or with ``multi_pod``
    (2, 16, 16) over ("pod", "data", "model"), 512 ranks.  Raises, as
    ``make_debug_mesh`` does, when the group has another size.  The
    dry-run builds it over placeholder ranks (``launch/hostdev.py``).

    The shapes are the TPU pods' (a v5e pod is 16 x 16 chips).  On H100
    nodes of 8 NVLinked cards a "model" axis of 16 spans two nodes, so its
    collectives would cross the slower inter-node links."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_debug_mesh(shape, device=device)
