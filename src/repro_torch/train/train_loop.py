"""Training step: next-token cross entropy plus ``router_aux_loss_coef``
times the MoE layers' load-balance loss (0 for a stack without MoE
layers), remat and the train-step factory (port of
``repro/train/train_loop.py``).

The step runs the full forward (``models.model.forward_hidden``, attention
through ``attention.masked_attention``), autograd and AdamW in plain torch
ops, as the reference's training runs XLA, with one exception: a Mamba
layer's selective scan.  The reference differentiates its XLA scan; the
port's scan is K5, so on the card the scan trains through K5 and K5's
backward kernel (``kernels/mamba_scan.mamba_scan_train``: with remat, K5
runs twice a Mamba layer a step, its backward once), and on the CPU
through autograd of K5's plain version.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models import model as M
from ..models.config import ModelConfig
from ..distributed import act_sharding
from ..models.layers import lm_logits
from .optimizer import AdamWConfig, adamw_update, init_opt_state, tree_map

LOSS_CHUNK = 512        # time-chunk for the big-vocab cross entropy
CHUNKED_LOSS_MIN_T = 2048


def _nll_sum(embed, cfg: ModelConfig, hidden, labels) -> torch.Tensor:
    """Summed next-token NLL of ``labels`` under the logits of ``hidden``,
    log-softmax in float32."""
    logits = act_sharding.constrain(lm_logits(embed, hidden, cfg), "logits")
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].sum()


def _ce_from_hidden(params, cfg: ModelConfig, hidden: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy from final hidden states (B, T, d).  From
    CHUNKED_LOSS_MIN_T steps on (whole LOSS_CHUNK chunks) it runs over time
    chunks, each checkpointed so that backward recomputes its logits: the
    (B, T, vocab) float32 logits never materialise."""
    B, T, _ = hidden.shape
    if T < CHUNKED_LOSS_MIN_T or T % LOSS_CHUNK != 0:
        return _nll_sum(params["embed"], cfg, hidden, labels) / (B * T)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, T, LOSS_CHUNK):
        total = total + checkpoint(
            _nll_sum, params["embed"], cfg, hidden[:, lo:lo + LOSS_CHUNK],
            labels[:, lo:lo + LOSS_CHUNK], use_reentrant=False)
    return total / (B * T)


def _metrics(loss, aux) -> Dict[str, torch.Tensor]:
    loss = loss.detach()
    return {"loss": loss, "aux_loss": aux.detach(),
            "ppl": torch.exp(torch.clamp(loss, 0, 20.0))}


def lm_loss(params, cfg: ModelConfig, batch: torch.Tensor,
            remat: bool = False) -> Tuple[torch.Tensor, Dict]:
    """batch: (B, T+1) int -> (loss, metrics)."""
    inputs, labels = batch[:, :-1], batch[:, 1:]
    hidden, aux = M.forward_hidden(params, cfg, tokens=inputs, remat=remat)
    loss = _ce_from_hidden(params, cfg, hidden, labels)
    return loss + cfg.router_aux_loss_coef * aux, _metrics(loss, aux)


def encoder_loss(params, cfg: ModelConfig, embeds: torch.Tensor,
                 targets: torch.Tensor, remat: bool = False
                 ) -> Tuple[torch.Tensor, Dict]:
    """Embedding-input losses (HuBERT-style per-frame unit prediction, or
    a VLM backbone on precomputed embeddings): frame embeddings (B, T, d)
    -> targets (B, T)."""
    hidden, aux = M.forward_hidden(params, cfg, embeds=embeds, remat=remat)
    loss = _ce_from_hidden(params, cfg, hidden, targets)
    loss = loss + cfg.router_aux_loss_coef * aux
    return loss, _metrics(loss, aux)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    remat: bool = True, donate: bool = False) -> Callable:
    """Returns train_step(train_state, batch) -> (train_state, metrics).

    train_state = {"params": ..., "opt": ...}; batch is the (B, T+1) token
    block (a tensor or a numpy array, moved to the parameters' device), or
    (embeds, targets) for an embedding-input config.  The state passed in
    is left as it is, unless ``donate``: then its tensors are updated in
    place and returned (the same values; ``adamw_update``), as a jit that
    donates its state would, so that a step holds one copy of the
    parameters and moments (a model whose two copies overflow the card).
    Metrics are 0-dim tensors on the device (reading one waits for the
    step): loss, aux_loss, ppl, grad_norm, lr, total_loss.
    """
    def train_step(train_state, batch):
        params = train_state["params"]
        dev = params["final_norm"]["scale"].device
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = []
        tree_map(leaves.append, live)
        with torch.enable_grad():
            if cfg.embedding_inputs:
                embeds, targets = (torch.as_tensor(t, device=dev)
                                   for t in batch)
                loss, metrics = encoder_loss(live, cfg, embeds, targets,
                                             remat)
            else:
                loss, metrics = lm_loss(live, cfg,
                                        torch.as_tensor(batch, device=dev),
                                        remat)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, params, grads, train_state["opt"], donate=donate)
        metrics = {**metrics, **opt_metrics, "total_loss": loss.detach()}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device="cuda") -> Dict[str, Any]:
    """Seeded parameters (``models.model.init_params``) and a fresh
    optimizer state, on ``device`` (the CUDA card unless ``"cpu"``)."""
    params = M.init_params(cfg, seed=seed, device=device)
    return {"params": params, "opt": init_opt_state(params)}
