"""Training for the port: the LM loss, the optimizer and the train step
(:mod:`.train`), and the checkpointing loop (:mod:`.trainer`); the
single-process device mesh of tensor-parallel and position-striped
serving (:mod:`.mesh`: the Megatron split of the weights, KV storage and
the adapter pool on heads over ``tp``, the paged pool's pages over
``sp``).

Counterpart of ``tpushare/parallel/``'s single-device training path and
of its mesh's ``tp`` and ``sp`` axes.  Sharded training (ROADMAP A.11),
the pipelined and expert-parallel axes and ring/ulysses attention wait
for later slices (ROADMAP A.12)."""

from .train import (ATTN_SAVING_POLICY, AdamW, lm_loss,  # noqa: F401
                    make_loss_fn, make_lr_schedule, make_optimizer,
                    make_train_step)
