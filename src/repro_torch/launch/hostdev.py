"""Placeholder ranks for the dry-run (port of ``repro/launch/hostdev.py``).

The reference provisions placeholder devices by extending ``XLA_FLAGS``
before jax is imported.  The port's counterpart is a placeholder process
group: ``dist.init_process_group("fake", ...)`` in this process, as rank 0
of ``n`` ranks, whose collectives return without moving data, so a
``DeviceMesh`` of the reference's production shape can be built over it and
each rank's program traced under ``FakeTensorMode`` (``launch/dryrun.py``).

The reference's rules carry over:
  - never replace the caller's process group (a real one, or a fake one
    of another size: the mesh build then raises on the size);
  - never act once it is too late: with a group already initialised,
    change nothing.

Importing this module starts no process group; ``parse_mesh_shape`` lives
in ``launch/mesh.py``.
"""
from __future__ import annotations

import sys
from typing import Optional


def ensure_placeholder_ranks(n: int) -> bool:
    """Start a ``"fake"`` process group of ``n`` ranks (this process rank 0)
    unless a process group is already initialised.  Returns whether it
    started one."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    if "fake" in dist.Backend.backend_list:
        dist.init_process_group("fake", rank=0, world_size=int(n))
    else:
        # releases before the backend was built in register it here
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", rank=0, world_size=int(n),
                                store=FakeStore())
    return True


def mesh_arg(argv=None) -> Optional[str]:
    """Early peek at ``--mesh`` (before argparse, so that an entry point
    can size its process group first)."""
    argv = sys.argv if argv is None else argv
    for i, a in enumerate(argv):
        if a == "--mesh" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--mesh="):
            return a.split("=", 1)[1]
    return None
