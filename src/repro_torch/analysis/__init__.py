"""The port's contract checker (port of ``repro/analysis``, DESIGN.md
§13): the engine's step contracts, checked mechanically.

Two levels:

  - **Level 1 (runtime)** runs the real ``spec_step``, ``admit_slot`` and
    ``release_slot`` on concrete states of a registry of serving
    configurations and checks that every state leaf is written in place
    (``in-place``), that the state's signature is a fixed point
    (``state-signature``) and that the step reads nothing back to the host
    (``host-sync``), and that every state leaf has a sharding rule that
    does not fall back to replication on the reference's three meshes
    (``sharding-coverage``).  It runs on the card unless ``device="cpu"``
    is given.
  - **Level 2 (AST)** lints ``src/repro_torch`` for source rules:
    kernel-scope, tensor-branch, hash-constants, global-state,
    time-in-step, plus the serving loop's host-sync inventory.

CLI: ``python -m repro_torch.analysis [--strict] [--level {1,2}]
[--baseline PATH] [--syncmap PATH] [--json] [--list-rules] [--device]``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from .findings import Baseline, Finding, apply_waivers, scan_waivers

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_ROOT = os.path.dirname(PACKAGE_DIR)          # .../src/repro_torch
DEFAULT_BASELINE = os.path.join(PACKAGE_DIR, "baseline.json")

RULES: Dict[str, str] = {
    # level 1 (runtime)
    "in-place": "every DecodeState leaf keeps its storage across "
                "step/admit/release; no two leaves share one",
    "state-signature": "the state's structure, shapes, dtypes and device "
                       "are a fixed point of step/admit/release",
    "host-sync": "no device->host read or host-data tensor in the step, no "
                 "device->host read in admit/release, no un-waived read "
                 "in the serving critical path",
    "sharding-coverage": "every DecodeState leaf of every case has a "
                         "sharding rule on the registry meshes, and none "
                         "falls back to replication",
    # level 2 (AST)
    "kernel-scope": "ctypes/triton/cpp_extension and build.load only "
                    "inside kernels/",
    "tensor-branch": "no Python branch on, or host read of, a tensor in "
                     "core/ and models/",
    "hash-constants": "hash constants only in kernels/hashing.py",
    "global-state": "no module-level process mutation or mesh install; a "
                    "rebound module global is restored by a context "
                    "manager; act_sharding.install is paired with "
                    "uninstall or activated",
    "time-in-step": "no wall clock or host RNG in the step functions",
}


def run_all(level: Optional[int] = None, src_root: str = SRC_ROOT,
            device="cuda") -> Tuple[List[Finding], List[Dict]]:
    """Run the requested level(s); returns (findings, host-sync
    inventory).  Level 2 is AST work and imports nothing of the engine;
    level 1 builds the registry's models on ``device``."""
    findings: List[Finding] = []
    inventory: List[Dict] = []
    if level in (None, 2):
        from .ast_rules import run_level2
        got, inventory = run_level2(src_root)
        findings += got
    if level in (None, 1):
        from .runtime_rules import run_level1
        lvl1 = run_level1(device=device)
        findings += lvl1
        inventory += [{"file": f.file, "line": f.line, "method": "<runtime>",
                       "call": f.context, "kind": "step-body sync",
                       "code": f.message, "waived": f.waived,
                       "reason": f.waive_reason}
                      for f in lvl1 if f.rule == "host-sync"]
    return findings, inventory


__all__ = ["Baseline", "Finding", "RULES", "DEFAULT_BASELINE", "SRC_ROOT",
           "apply_waivers", "scan_waivers", "run_all"]
