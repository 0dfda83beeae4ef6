"""Training for the port: the LM loss, the optimizer and the train steps
(:mod:`.train`: one device, a ``dp`` / ``fsdp`` / ``tp`` mesh, and the
1F1B pipelined step over ``pp``), and the checkpointing loop
(:mod:`.trainer`, ``Trainer(mesh=)``); the single-process device mesh
(:mod:`.mesh`: the Megatron split of the weights, KV storage and the
adapter pool on heads over ``tp``, the paged pool's pages over ``sp``,
the layers of all three by stage over ``pp``, the params once a ``dp``
shard and in ``fsdp`` blocks, the batch's rows over ``dp``); the GPipe
schedule and its forward, and the 1F1B schedule and its training pass
(:mod:`.pipeline`); and sequence-parallel long-context attention over
the mesh's ``sp`` shards, the ring (:mod:`.ring`, plain and zigzag) and
the all-to-all (:mod:`.ulysses`), which ``models.transformer.forward(
attention_fn=)`` runs, forward and backward.

Counterpart of ``tpushare/parallel/``: its training steps and trainer,
its mesh's ``tp``, ``sp``, ``pp``, ``dp`` and ``fsdp`` axes, its pipeline
and its ring and Ulysses attention.  The expert-parallel axis (ROADMAP
A.12.4) waits for a later slice."""

from .train import (ATTN_SAVING_POLICY, AdamW, lm_loss,  # noqa: F401
                    make_loss_fn, make_lr_schedule, make_optimizer,
                    make_pipeline_train_step, make_train_step,
                    pipeline_loss_and_grads, sharded_loss_and_grads)
