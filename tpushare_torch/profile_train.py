"""Where a training step's time goes on the card.

    python -m tpushare_torch.profile_train [--model llama3-8b] [--steps 2]

Builds a ``Trainer`` with random seeded weights (AdamW, lr 3e-4,
``remat="layer"``, ``head_chunk=512``) and one seeded [1, 2049] batch,
runs ``--steps`` train steps unprofiled, then again under
``torch.profiler`` (CPU and CUDA activity), and prints one JSON line:
host wall per step, device busy time and its share of the unprofiled
wall, device operations per step, the kernels with the most device time,
the port's own kernels (K1, K3, K4) and the host operators with the most
self time (as :mod:`tpushare_torch.profile_decode` reports a serving
step), plus the peak device memory.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .models import transformer
from .parallel.trainer import Trainer
from .profile_decode import _profiled

MODELS = {"llama3-8b": transformer.llama3_8b,
          "flagship-small": transformer.flagship_small}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpushare_torch.profile_train")
    ap.add_argument("--model", default="llama3-8b", choices=sorted(MODELS))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    cfg = MODELS[args.model]()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, lr=3e-4, seed=args.seed, remat="layer",
                      head_chunk=512, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (1, 2049)), device="cuda")
    res = _profiled(lambda: trainer.run(iter([tokens]), 1), args.steps)
    res.update({"phase": "train", "model": args.model, "batch": [1, 2049],
                "remat": "layer", "head_chunk": 512,
                "device": torch.cuda.get_device_name(0),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
