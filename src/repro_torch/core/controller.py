"""Adaptive (k, w) controller (port of ``repro/core/controller.py``).

The paper sweeps a static (k, w) grid offline and notes (§5.2) that a
smarter allocation "could yield further gains".  This controller picks the
strategy ONLINE from a small table of arms:

    score(arm) = EMA_tokens_per_call(arm) / roofline_slowdown(arm | ell)

measured acceptance divided by the modelled call-time inflation
(``core/phase.py``, priced for the H100), plus a UCB exploration bonus.

Two implementations share the scoring rule:

  - ``AdaptiveKW``: the host-side bandit, one arm per whole *batch*
    (``ServingEngine.serve_all`` picks before each ``generate``).
  - the per-slot bandit (``init_arm_stats`` / ``choose_arms`` /
    ``update_arm_stats``): torch ops over (B, A) stat tensors that live in
    ``DecodeState.stats`` and run inside ``spec_step`` on the state's
    device, reading nothing back to the host.  Every slot keeps its own
    counts and rewards, so a continuous-batching engine adapts per request
    in flight; admission and release zero a slot's rows, so a reused slot
    explores afresh.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import torch

from ..models.config import ModelConfig
from .phase import slowdown


@dataclasses.dataclass
class ArmStats:
    tokens: float = 0.0
    calls: float = 0.0
    pulls: int = 0

    @property
    def tpc(self) -> float:
        return self.tokens / self.calls if self.calls else 1.0


DEFAULT_ARMS: Tuple[Tuple[int, int], ...] = ((1, 0), (5, 4), (10, 4),
                                             (10, 10), (25, 2))

# the reference's defaults (SpecConfig.adapt_explore/adapt_ema/adapt_ell
# there), fixed here: nothing in the port tunes them
EXPLORE = 0.3   # UCB exploration coefficient
EMA = 0.9       # per-arm tokens-per-call EMA decay
ELL = 512       # context length of the roofline prior


class AdaptiveKW:
    def __init__(self, cfg: ModelConfig,
                 arms: Tuple[Tuple[int, int], ...] = DEFAULT_ARMS):
        self.cfg = cfg
        self.arms: List[Tuple[int, int]] = list(arms)
        self.stats: Dict[Tuple[int, int], ArmStats] = {
            a: ArmStats() for a in self.arms}
        # modelled call slowdown per arm (the roofline prior)
        self.slow: Dict[Tuple[int, int], float] = dict(
            zip(self.arms, arm_slowdowns(cfg, tuple(self.arms))))
        self.total_pulls = 0

    def score(self, arm: Tuple[int, int]) -> float:
        s = self.stats[arm]
        # optimistic prior before any pull: half the draft accepted
        tpc = s.tpc if s.pulls else 1.0 + arm[1] * 0.5
        bonus = EXPLORE * math.sqrt(
            math.log(self.total_pulls + 1) / (s.pulls + 1e-9)) \
            if s.pulls else float("inf")
        return tpc / self.slow[arm] + bonus

    def choose(self) -> Tuple[int, int]:
        return max(self.arms, key=self.score)

    def update(self, arm: Tuple[int, int], tokens: float,
               calls: float) -> None:
        s = self.stats[arm]
        if s.pulls:
            s.tokens = EMA * s.tokens + (1 - EMA) * tokens
            s.calls = EMA * s.calls + (1 - EMA) * calls
        else:
            s.tokens, s.calls = tokens, calls
        s.pulls += 1
        self.total_pulls += 1


# ---------------------------------------------------------------------------
# the per-slot bandit (runs inside spec_step)
# ---------------------------------------------------------------------------
# One pull is one verify call of one slot, rewarded with the tokens that
# call committed (n_commit, bonus included): the per-call counterpart of
# AdaptiveKW's whole-batch tokens/calls EMA.  All state is (B, A) tensors
# keyed into DecodeState.stats, so it is slot-reset with the other per-slot
# stats and needs no host round trip.
ARM_STAT_KEYS = ("arm_pulls", "arm_reward", "arm_last")

# scores are f32; any finite exploit score is < _UNPULLED, so unpulled arms
# are explored first in index order (AdaptiveKW's infinite bonus)
_UNPULLED = 1e30


def init_arm_stats(num_slots: int, num_arms: int,
                   device="cpu") -> Dict[str, torch.Tensor]:
    """Fresh per-slot bandit state: zero pulls and rewards for every arm."""
    return {
        "arm_pulls": torch.zeros((num_slots, num_arms), dtype=torch.int32,
                                 device=device),
        "arm_reward": torch.zeros((num_slots, num_arms), dtype=torch.float32,
                                  device=device),
        "arm_last": torch.zeros((num_slots,), dtype=torch.int32,
                                device=device),
    }


@functools.lru_cache(maxsize=None)
def arm_slowdowns(cfg: ModelConfig, arms: Tuple[Tuple[int, int], ...]
                  ) -> Tuple[float, ...]:
    """Roofline call-slowdown prior per arm (the score's denominator) at
    context ``ELL``: host floats from static shapes, computed once per
    (config, table)."""
    return tuple(slowdown(cfg, ELL, k, w) if (k, w) != (1, 0) else 1.0
                 for (k, w) in arms)


@functools.lru_cache(maxsize=None)
def tree_arm_slowdowns(cfg: ModelConfig, arms: Tuple[Tuple[int, int], ...],
                       branch: int) -> Tuple[float, ...]:
    """Roofline prior for TREE arms: a (width, depth) arm verifies
    num_nodes(width, depth, branch) + 1 inputs as ONE row, so its call is
    priced as slowdown(cfg, ELL, 1, N), not as width independent rows.
    Depth-0 arms verify only the root (plain greedy): 1.0."""
    from .tree import num_nodes
    return tuple(
        slowdown(cfg, ELL, 1, num_nodes(k, w, branch)) if w > 0 else 1.0
        for (k, w) in arms)


def choose_arms(stats: Dict[str, torch.Tensor], slowdowns) -> torch.Tensor:
    """UCB arm per slot from (B, A) stats; ties break to the lowest index.

    score = EMA_tokens_per_call / slowdown + EXPLORE * sqrt(log(T) / pulls)
    in f32, never-pulled arms forced first in index order.  Rows are
    independent: slot b's choice reads only stats[b].  ``slowdowns``: a
    tuple, or an (A,) f32 tensor on the stats' device (the step passes
    one, so that it copies nothing from the host).  Returns (B,) int32.
    """
    pulls = stats["arm_pulls"]                              # (B, A) int32
    pulled = pulls > 0
    total = pulls.sum(dim=1, keepdim=True)                  # per-slot T
    bonus = EXPLORE * torch.sqrt(
        torch.log(total.to(torch.float32) + 1.0)
        / pulls.to(torch.float32).clamp(min=1.0))
    slow = torch.as_tensor(slowdowns, dtype=torch.float32,
                           device=pulls.device)[None, :]
    score = torch.where(pulled, stats["arm_reward"] / slow + bonus,
                        _UNPULLED)
    return torch.argmax(score, dim=1).to(torch.int32)       # first max


def update_arm_stats(stats: Dict[str, torch.Tensor], arm: torch.Tensor,
                     reward: torch.Tensor, active: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """Record one pull of ``arm[b]`` with ``reward[b]`` tokens for every
    active slot (inactive rows are untouched, like the per-slot call and
    token counters).  The first pull seeds the EMA with the raw reward
    (AdaptiveKW's rule)."""
    pulls = stats["arm_pulls"]
    A = pulls.shape[1]
    sel = ((torch.arange(A, device=pulls.device)[None, :]
            == arm[:, None].long()) & active[:, None])
    first = pulls == 0
    reward = torch.as_tensor(reward).to(torch.float32)[:, None]
    blended = torch.where(first, reward,
                          EMA * stats["arm_reward"] + (1.0 - EMA) * reward)
    return {**stats,
            "arm_pulls": pulls + sel.to(torch.int32),
            "arm_reward": torch.where(sel, blended, stats["arm_reward"]),
            "arm_last": torch.where(active, arm.to(torch.int32),
                                    stats["arm_last"])}
