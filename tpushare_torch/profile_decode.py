"""Where a serving step's time goes on the card.

    python -m tpushare_torch.profile_decode [--model llama3-8b] [--steps 8]
        [--int8] [--kv-dtype int8] [--sp 2]

Builds the model with random seeded weights (``--int8``: int8 weights,
``--kv-dtype int8``: an int8 KV pool) and a paged batcher (8 slots,
pages of 16; ``--sp N``: its pool striped over N position stripes, all
on the one card), admits one request per slot (prompts of 256..2000
tokens), then profiles, with ``torch.profiler`` over CPU and CUDA
activity:

* ``decode``: ``--steps`` batched decode ticks;
* ``prefill``: one 2000-token prompt admission;
* ``score``: the no-cache forward of ``/score`` over 2048 tokens.

Each phase runs once unprofiled, then again under the profiler.  Prints
one JSON line per phase: host wall time per step (around work that ends
in a synchronize) of both runs, device busy time (the sum of kernel
times, from the profiled run) and its share of the unprofiled wall,
device operations per step, the kernels with the most device time, and
the host operators with the most self time.  Under ``--sp`` the decode
and prefill lines also split out K2's striped variant (its launches and
device time) and the cross-stripe merge (the kernels launched inside
``sp_merge_partials``'s profiler range).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .models import transformer
from .parallel.mesh import make_mesh
from .serving.llm import build_model
from .serving.paged import PagedContinuousBatcher
from .serving.score import score_tokens

PROMPTS = (256, 512, 1000, 2000, 300, 700, 1200, 1600)

#: K2's striped instantiations, both arms (``paged_prefill_kernel<D,
#: Pool, true>`` at S > 1, ``paged_decode_kernel<D, Pool, true>`` at
#: S = 1, its combine folded into its tail)
STRIPED_K2 = re.compile(r"paged_(prefill|decode)_kernel<.*true>")


def _summary(prof, wall_s: float, prof_wall_s: float, steps: int,
             top: int = 12) -> dict:
    rows, host = [], []
    busy_us = 0.0
    launches = 0
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue              # a named range's span, not device work
        if e.device_type != DeviceType.CUDA:     # host-side operators
            if e.self_cpu_time_total > 0:
                host.append((e.self_cpu_time_total, e.key, e.count))
            continue
        dev_us = e.self_device_time_total        # kernels, memcpy, memset
        if dev_us <= 0:
            continue
        busy_us += dev_us
        launches += e.count
        rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    host.sort(reverse=True)

    def table(entries):
        return [{"name": k[:90], "ms_per_step": us / 1e3 / steps,
                 "calls_per_step": n / steps} for us, k, n in entries[:top]]

    striped = [(us, n) for us, k, n in rows if STRIPED_K2.search(k)]
    merge_us, merge_ops = 0.0, 0
    for ev in prof.events():
        if ev.name == "sp_merge_partials" and \
                ev.device_type == DeviceType.CPU:
            merge_us += ev.device_time_total
            stack = [ev]
            while stack:
                e = stack.pop()
                merge_ops += len(e.kernels)
                stack.extend(e.cpu_children)
    # kernel times do not change under the profiler; the host's do
    return {"wall_ms_per_step": wall_s * 1e3 / steps,
            "striped_k2_ms_per_step": sum(u for u, _ in striped) / 1e3 / steps,
            "striped_k2_launches_per_step": sum(n for _, n in striped) / steps,
            "sp_merge_ms_per_step": merge_us / 1e3 / steps,
            "sp_merge_ops_per_step": merge_ops / steps,
            "wall_ms_per_step_profiled": prof_wall_s * 1e3 / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "device_ops_per_step": launches / steps,
            "top_kernels": table(rows),
            # the port's own kernels (C++ namespace tpushare), whatever
            # their rank
            "port_kernels": table([r for r in rows if "tpushare::" in r[1]]),
            # self time on the host, profiler overhead included
            "top_host_ops": table(host)}


def _profiled(fn, steps: int) -> dict:
    fn()                                     # warm-up (cuBLAS plans)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    return _summary(prof, wall, prof_wall, steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpushare_torch.profile_decode")
    ap.add_argument("--model", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights (the products dequantize a bf16 "
                         "copy of each weight)")
    ap.add_argument("--kv-dtype", choices=transformer.KV_DTYPES,
                    default="bf16")
    ap.add_argument("--sp", type=int, default=1,
                    help="position stripes of the pool, all on this card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    cfg, params = build_model(args.model, quantize_int8=args.int8,
                              seed=args.seed, kv_dtype=args.kv_dtype,
                              device="cuda")
    mesh = (make_mesh({"sp": args.sp}, devices=["cuda"] * args.sp)
            if args.sp > 1 else None)
    dev_kw = {"mesh": mesh} if mesh is not None else {"device": "cuda"}
    rng = np.random.default_rng(args.seed)
    b = PagedContinuousBatcher(params, cfg, n_slots=len(PROMPTS),
                               page_size=16, **dev_kw)
    for n in PROMPTS:
        b.admit(rng.integers(0, cfg.vocab, n).tolist(), 10_000 // n + 64)
    dev = torch.cuda.get_device_name(0)

    res = _profiled(b.tick, args.steps)
    res.update({"phase": "decode", "model": args.model, "device": dev,
                "weights": "int8" if args.int8 else "bf16",
                "kv_dtype": args.kv_dtype, "slots": len(PROMPTS),
                "sp": args.sp})
    print(json.dumps(res), flush=True)

    pb = PagedContinuousBatcher(params, cfg, n_slots=1, page_size=16,
                                n_pages=200, **dev_kw)
    prompt = rng.integers(0, cfg.vocab, 2000).tolist()

    def prefill():
        if not pb._reserve(0, len(prompt), 1):
            raise RuntimeError("the prefill pool has no room for the prompt")
        pb._prefill_into(0, prompt)
        torch.cuda.synchronize()
        pb._release(0)

    res = _profiled(prefill, 2)
    res.update({"phase": "prefill", "prompt": len(prompt), "device": dev,
                "sp": args.sp})
    print(json.dumps(res), flush=True)

    toks = torch.tensor([rng.integers(0, cfg.vocab, 2048).tolist()],
                        device="cuda")
    res = _profiled(lambda: score_tokens(params, cfg, toks), 2)
    res.update({"phase": "score", "tokens": 2048, "device": dev,
                "layers": cfg.n_layers,
                "flops_per_token_gemm": 2 * transformer.param_count(params)})
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
