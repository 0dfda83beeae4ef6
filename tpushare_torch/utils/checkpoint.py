"""Parameter and train-state checkpointing for the port.

Counterpart of ``tpushare/utils/checkpoint.py``:

* :func:`save_params` / :func:`load_params`: a nested dict of tensors as
  ONE flat ``.npz`` in the JAX package's format (keys are ``/``-joined
  paths; bf16 stored as a uint16 view under a ``__bf16`` suffix), so a
  file written by either package loads in the other (the port's side
  through :func:`tpushare_torch.models.bridge.params_from_numpy`).
* :func:`save_train_state` / :func:`load_train_state`: a one-shot
  train state (any tree of dicts, tuples, tensors and numbers) as one
  ``torch.save`` file in a FRESH directory, which the save refuses to
  overwrite.
* :func:`make_checkpoint_manager` / :func:`save_step` /
  :func:`restore_latest`: periodic train-state checkpoints, one
  ``torch.save`` file in a step-numbered directory each (the JAX package
  uses orbax).  A new step is committed (temp file, then ``os.replace``)
  before old steps are pruned, so no crash window loses the state.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

_BF16_SUFFIX = "__bf16"
STATE_FILE = "state.pt"


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    key = prefix[:-1]
    t = torch.as_tensor(tree).detach().cpu()
    if t.dtype == torch.bfloat16:
        out[key + _BF16_SUFFIX] = t.view(torch.int16).numpy().view(np.uint16)
    else:
        out[key] = t.numpy()
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    root: dict = {}
    for key, arr in flat.items():
        if key.endswith(_BF16_SUFFIX):
            key = key[: -len(_BF16_SUFFIX)]
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return root


def _atomic_write(path: str, write) -> None:
    """``write(file)`` into a temp file beside ``path``, then rename."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_params(path: str, params: dict) -> None:
    """Atomic save (write temp + rename) of a nested dict of tensors."""
    flat = _flatten(params)
    _atomic_write(path, lambda f: np.savez(f, **flat))


def load_params(path: str) -> dict:
    """The nested dict of CPU tensors saved by :func:`save_params` (or by
    the JAX package's ``save_params``), each in its saved dtype."""
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


# ---------------------------------------------------------------------------
# one-shot train state
# ---------------------------------------------------------------------------
def _plain(tree):
    """``tree`` with every tuple kind (``Staged``, ``Replicas``, fsdp
    blocks) a plain tuple and every tensor detached, which a
    ``weights_only`` load reads back."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_plain(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def _like(tree, like):
    """The loaded ``tree`` in ``like``'s structure (its container types)
    with each tensor on the device of ``like``'s tensor there."""
    if isinstance(like, dict):
        if set(tree) != set(like):
            raise ValueError(f"checkpoint keys {sorted(tree)} are not "
                             f"like's {sorted(like)}")
        return {k: _like(tree[k], v) for k, v in like.items()}
    if isinstance(like, tuple):
        if len(tree) != len(like):
            raise ValueError(f"checkpoint holds {len(tree)} parts where "
                             f"like has {len(like)}")
        return type(like)(_like(t, v) for t, v in zip(tree, like))
    if isinstance(like, torch.Tensor):
        return tree.to(like.device)
    return tree


def save_train_state(ckpt_dir: str, state) -> None:
    """One-shot save of a train state to a FRESH directory: written under
    a temporary name beside it, then renamed into place.

    Refuses to overwrite, as the reference does: an overwrite deletes the
    old checkpoint before the new one is committed, a crash window that
    loses all state.  Periodic checkpointing must use
    :func:`make_checkpoint_manager` (step-numbered dirs, retention),
    which never deletes the old step before the new one is committed."""
    path = os.path.abspath(ckpt_dir)
    if os.path.exists(path):
        raise FileExistsError(
            f"{path} exists; use make_checkpoint_manager for periodic "
            f"checkpointing (atomic across overwrites)")
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".tmp-")
    try:
        torch.save(_plain(state), os.path.join(tmp, STATE_FILE))
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_train_state(ckpt_dir: str, like=None):
    """The state :func:`save_train_state` wrote, its tensors on the host;
    with ``like`` (a tree of the same layout), in ``like``'s structure
    with each tensor on ``like``'s device there.  Every tensor comes back
    bit-equal, int8 and int4 ``{"q", "s"}`` leaves included."""
    state = torch.load(os.path.join(os.path.abspath(ckpt_dir), STATE_FILE),
                       map_location="cpu", weights_only=True)
    return state if like is None else _like(state, like)


# ---------------------------------------------------------------------------
# periodic train-state checkpoints
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CheckpointManager:
    """Step-numbered checkpoints under ``directory``; the newest
    ``max_to_keep`` survive (None keeps every step)."""
    directory: str
    max_to_keep: Optional[int] = 3

    def steps(self) -> List[int]:
        """Committed steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None


def make_checkpoint_manager(ckpt_dir: str,
                            max_to_keep: Optional[int] = 3
                            ) -> CheckpointManager:
    """Step-numbered checkpoint manager (the crash-safe periodic form)."""
    path = os.path.abspath(ckpt_dir)
    os.makedirs(path, exist_ok=True)
    return CheckpointManager(path, max_to_keep)


def save_step(mgr: CheckpointManager, step: int, state) -> None:
    """Commit ``state`` (a nested dict of tensors and numbers) as step
    ``step``, then prune the steps beyond ``mgr.max_to_keep``."""
    d = os.path.join(mgr.directory, str(int(step)))
    os.makedirs(d, exist_ok=True)
    _atomic_write(os.path.join(d, STATE_FILE),
                  lambda f: torch.save(state, f))
    if mgr.max_to_keep:
        for old in mgr.steps()[:-mgr.max_to_keep]:
            shutil.rmtree(os.path.join(mgr.directory, str(old)))


def restore_latest(mgr: CheckpointManager, device=None):
    """(step, state) of the manager's latest checkpoint, loaded onto
    ``device`` (default: where it was saved from); (None, None) when
    there is none."""
    step = mgr.latest_step()
    if step is None:
        return None, None
    path = os.path.join(mgr.directory, str(step), STATE_FILE)
    return step, torch.load(path, map_location=device, weights_only=True)
