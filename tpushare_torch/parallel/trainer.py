"""Training loop with periodic checkpointing and resume.

Counterpart of ``tpushare/parallel/trainer.py`` on one device: a
restarted trainer resumes from the latest step-numbered checkpoint
(:mod:`tpushare_torch.utils.checkpoint`, which commits a new step before
it prunes old ones) and continues bit-identically.

``lora_rank`` > 0 fine-tunes adapters on the seeded base
(``ops.lora``): the params are the loraized tree, the optimizer state
covers the adapter dict alone, and a checkpoint holds that dict and its
state (the frozen base is drawn again from the seed at a resume).  On an
MoE config the adapters sit on the attention projections only.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterator, Optional

import torch

from .. import default_device
from ..models import transformer
from ..ops import lora
from ..utils import checkpoint
from .train import make_optimizer, make_train_step

log = logging.getLogger("tpushare_torch.trainer")


class Trainer:
    """``cfg``'s model trained from fresh seeded params (or the latest
    checkpoint under ``ckpt_dir``) on ``device`` (default ``cuda``).
    ``head_chunk`` > 0 turns on the chunked loss
    (:func:`~tpushare_torch.parallel.train.lm_loss`).  ``lora_rank`` > 0
    trains rank-``lora_rank`` adapters (scale ``lora_alpha / lora_rank``)
    on every projection the tree has, the base frozen."""

    def __init__(self, cfg: transformer.ModelConfig, mesh=None,
                 ckpt_dir: Optional[str] = None,
                 save_every: int = 100,
                 max_to_keep: int = 3,
                 lr: float = 3e-4, seed: int = 0,
                 remat: str = "none",
                 schedule: str = "constant", warmup_steps: int = 0,
                 total_steps: int = 0, grad_clip_norm: float = 0.0,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 head_chunk: int = 0, device=None):
        if mesh is not None:
            raise ValueError("mesh: sharded training is not ported yet "
                             "(ROADMAP A.11)")
        self.cfg = cfg
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.device = default_device(device)
        self.save_every = save_every
        self.optimizer = make_optimizer(
            lr=lr, schedule=schedule, warmup_steps=warmup_steps,
            total_steps=total_steps, grad_clip_norm=grad_clip_norm)
        make_step = (lora.make_lora_train_step if lora_rank > 0
                     else make_train_step)
        self.step_fn = make_step(cfg, self.optimizer, remat=remat,
                                 head_chunk=head_chunk)
        self._mgr = (checkpoint.make_checkpoint_manager(ckpt_dir, max_to_keep)
                     if ckpt_dir else None)
        self.step = 0
        latest, restored = (checkpoint.restore_latest(self._mgr, self.device)
                            if self._mgr else (None, None))
        # the restore loads straight onto the device: no throwaway fresh
        # init beside it (two copies of params + state at the resume)
        if restored is not None and lora_rank > 0:
            _, frozen = lora.partition(self._fresh_params(seed))
            self.params = lora.combine(restored["adapters"], frozen)
        elif restored is not None:
            self.params = restored["params"]
        else:
            self.params = self._fresh_params(seed)
        if restored is not None:
            self.opt_state = restored["opt_state"]
            self.step = latest
            log.info("resumed from step %d", latest)
        else:
            self.opt_state = self.optimizer.init(self._trained())

    def _fresh_params(self, seed: int):
        """The seeded params, loraized when adapters train."""
        params = transformer.init_params(self.cfg, seed=seed,
                                         device=self.device)
        if self.lora_rank > 0:
            params = lora.loraize_params(params, rank=self.lora_rank,
                                         alpha=self.lora_alpha)
        return params

    def _trained(self):
        """What the optimizer updates: the params, or the adapter dict."""
        if self.lora_rank > 0:
            return lora.partition(self.params)[0]
        return self.params

    def run(self, batches: Iterator, n_steps: int,
            on_step: Optional[Callable[[int, float], None]] = None) -> float:
        """Run up to ``n_steps`` more steps on ``batches`` ([B, S+1]
        token arrays); returns the last loss.  Without ``on_step`` the
        loop never reads the loss back, so steps queue on the device
        asynchronously; the single sync happens at return."""
        loss = None
        for _ in range(n_steps):
            tokens = torch.as_tensor(next(batches), device=self.device)
            self.params, self.opt_state, loss = self.step_fn(
                self.params, self.opt_state, tokens)
            self.step += 1
            if on_step:
                on_step(self.step, float(loss))
            if self._mgr and self.save_every \
                    and self.step % self.save_every == 0:
                self.save()
        return float(loss) if loss is not None else float("nan")

    def save(self) -> None:
        if not self._mgr:
            return
        key = "adapters" if self.lora_rank > 0 else "params"
        checkpoint.save_step(self._mgr, self.step,
                             {key: self._trained(),
                              "opt_state": self.opt_state})
        log.info("checkpointed step %d", self.step)
