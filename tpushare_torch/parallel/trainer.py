"""Training loop with periodic checkpointing and resume.

Counterpart of ``tpushare/parallel/trainer.py``: a restarted trainer
resumes from the latest step-numbered checkpoint
(:mod:`tpushare_torch.utils.checkpoint`, which commits a new step before
it prunes old ones) and continues bit-identically.

``mesh`` picks the step as the reference does: a ``pp`` axis the 1F1B
step (``make_pipeline_train_step``, data-parallel over a ``dp`` axis
beside it), any other mesh the single-program step over the sharded
params and batch (``make_train_step(mesh=)``).  Params and moments are
placed by ``parallel.mesh.shard_params``, every batch by ``shard_batch``.
A checkpoint holds the whole (gathered) tree, so it resumes on another
mesh or on none.

``lora_rank`` > 0 fine-tunes adapters on the seeded base
(``ops.lora``): the params are the loraized tree, the optimizer state
covers the adapter dict alone, and a checkpoint holds that dict and its
state (the frozen base is drawn again from the seed at a resume).  On an
MoE config the adapters sit on the attention projections only.  On a
mesh (``dp``, ``fsdp``, ``tp``; not ``pp``) the loraized tree is laid out
by ``shard_params``, the base by its parent's rule, and the moments
like the adapters.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, Iterator, Optional

import torch

from .. import default_device
from ..models import transformer
from ..ops import lora
from ..utils import checkpoint
from .mesh import Mesh, gather_params, shard_batch, shard_params
from .train import (make_optimizer, make_pipeline_train_step,
                    make_train_step)

log = logging.getLogger("tpushare_torch.trainer")


class Trainer:
    """``cfg``'s model trained from fresh seeded params (or the latest
    checkpoint under ``ckpt_dir``) on ``device`` (default ``cuda``), or on
    ``mesh`` (a ``parallel.mesh.Mesh``; its first device then stands for
    ``device``).  ``head_chunk`` > 0 turns on the chunked loss
    (:func:`~tpushare_torch.parallel.train.lm_loss`).  ``lora_rank`` > 0
    trains rank-``lora_rank`` adapters (scale ``lora_alpha / lora_rank``)
    on every projection the tree has, the base frozen; on any mesh but
    a ``pp`` one.  ``quantize_bits`` 8 or 4 (with ``lora_rank`` only)
    draws that base int8 or int4 (``transformer.init_params``): QLoRA."""

    def __init__(self, cfg: transformer.ModelConfig, mesh=None,
                 ckpt_dir: Optional[str] = None,
                 save_every: int = 100,
                 max_to_keep: int = 3,
                 lr: float = 3e-4, seed: int = 0,
                 remat: str = "none",
                 schedule: str = "constant", warmup_steps: int = 0,
                 total_steps: int = 0, grad_clip_norm: float = 0.0,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 head_chunk: int = 0, device=None,
                 quantize_bits: int = 0):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be a tpushare_torch.parallel.mesh"
                             f".Mesh (make_mesh), got {type(mesh).__name__}")
        pp = mesh is not None and "pp" in mesh.axis_names
        if lora_rank > 0 and pp:
            raise ValueError("lora_rank with a pp mesh is not supported (the "
                             "1F1B step differentiates whole stage params)")
        if quantize_bits and lora_rank <= 0:
            raise ValueError("a quantized base trains adapters only: "
                             "quantize_bits needs lora_rank > 0")
        self.cfg = cfg
        self.mesh = mesh
        self.lora_rank = lora_rank
        self.quantize_bits = quantize_bits
        self.lora_alpha = lora_alpha
        self.device = (mesh.device() if mesh is not None
                       else default_device(device))
        self.save_every = save_every
        self.optimizer = make_optimizer(
            lr=lr, schedule=schedule, warmup_steps=warmup_steps,
            total_steps=total_steps, grad_clip_norm=grad_clip_norm)
        if lora_rank > 0:
            self.step_fn = lora.make_lora_train_step(
                cfg, self.optimizer, remat=remat, head_chunk=head_chunk,
                mesh=mesh)
        elif pp:
            self.step_fn = make_pipeline_train_step(
                cfg, self.optimizer, mesh,
                dp_axis="dp" if "dp" in mesh.axis_names else None)
        else:
            self.step_fn = make_train_step(cfg, self.optimizer, remat=remat,
                                           head_chunk=head_chunk, mesh=mesh)
        self._mgr = (checkpoint.make_checkpoint_manager(ckpt_dir, max_to_keep)
                     if ckpt_dir else None)
        self.step = 0
        latest, restored = (checkpoint.restore_latest(self._mgr, self.device)
                            if self._mgr else (None, None))
        # the restore loads straight onto the device: no throwaway fresh
        # init beside it (two copies of params + state at the resume)
        if restored is not None and lora_rank > 0:
            _, frozen = lora.partition(self._fresh_params(seed))
            params = lora.combine(restored["adapters"], frozen)
        elif restored is not None:
            params = restored["params"]
        else:
            params = self._fresh_params(seed)
        if restored is not None:
            opt_state = restored["opt_state"]
            self.step = latest
            log.info("resumed from step %d", latest)
        else:
            opt_state = self.optimizer.init(
                lora.partition(params)[0] if lora_rank > 0 else params)
        if mesh is not None:
            place = functools.partial(shard_params, mesh=mesh, cfg=cfg)
            if lora_rank > 0:
                # the moments mirror the adapters: laid out in the
                # loraized tree's places, then taken back out
                _, frozen = lora.partition(params)

                def place_moments(m):
                    return lora.placed_adapters(
                        place(lora.combine(m, frozen)))
            else:
                place_moments = place
            params = place(params)
            opt_state = {**opt_state, "mu": place_moments(opt_state["mu"]),
                         "nu": place_moments(opt_state["nu"])}
        self.params, self.opt_state = params, opt_state

    def _fresh_params(self, seed: int):
        """The seeded params, loraized when adapters train."""
        params = transformer.init_params(self.cfg, seed=seed,
                                         device=self.device,
                                         quantize_bits=self.quantize_bits)
        if self.lora_rank > 0:
            params = lora.loraize_params(params, rank=self.lora_rank,
                                         alpha=self.lora_alpha)
        return params

    def _trained(self):
        """What the optimizer updates: the params, or the adapter dict
        (one a dp replica on a mesh)."""
        if self.lora_rank == 0:
            return self.params
        return lora.placed_adapters(self.params)

    def run(self, batches: Iterator, n_steps: int,
            on_step: Optional[Callable[[int, float], None]] = None) -> float:
        """Run up to ``n_steps`` more steps on ``batches`` ([B, S+1]
        token arrays); returns the last loss.  Without ``on_step`` the
        loop never reads the loss back, so steps queue on the device
        asynchronously; the single sync happens at return."""
        loss = None
        for _ in range(n_steps):
            tokens = torch.as_tensor(next(batches), device=self.device)
            if self.mesh is not None:
                tokens = shard_batch(tokens, self.mesh)
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
        """Commit the step's state: the params (or adapters) and the
        optimizer state, gathered whole onto the host on a mesh."""
        if not self._mgr:
            return
        key = "adapters" if self.lora_rank > 0 else "params"
        state = {key: self._trained(), "opt_state": self.opt_state}
        if self.mesh is not None:
            def whole(tree):
                if self.lora_rank > 0:
                    return lora.whole_adapters(tree, "cpu")
                return gather_params(tree, self.cfg, "cpu")
            state = {key: whole(state[key]),
                     "opt_state": {**self.opt_state,
                                   "mu": whole(self.opt_state["mu"]),
                                   "nu": whole(self.opt_state["nu"])}}
        checkpoint.save_step(self._mgr, self.step, state)
        log.info("checkpointed step %d", self.step)
