"""K1's, K3's and K4's own device time on the card, beside the library's.

    python -m tpushare_torch.profile_k1 [--bwd] [--against DIR]

Times, by ``torch.profiler`` (the kernels' own durations, with the 50 MB
L2 flushed before every call), K1 and ``F.scaled_dot_product_attention(
..., is_causal=True, enable_gqa=True)`` at the serving ``/score`` shape
(B = 1, S = 2048, 32 heads over 8 kv heads, D = 128, causal) and at a long
one (S = 8192), and names the library's kernels.  With ``--bwd`` it times
the backward instead, at the same two shapes: K3 and K4 each, the port's
whole backward through autograd (dvec = rowsum(dO * O), K3 and K4) and
SDPA's backward through autograd (its own dO * O preprocess included).
With ``--against DIR`` (the root of another checkout, e.g. a ``git
archive`` of a parent commit unpacked into a git-ignored directory) it
also builds that checkout's ``flash_fwd`` (or, with ``--bwd``,
``flash_bwd``) library from its own sources and times it and this one in
turns (theirs, ours, ours, theirs) at S = 2048 on the same inputs, after
holding both to the plain version (20 calls a timing).  Prints one JSON
line a shape.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os

import torch

from .ops import attention as attn
from .utils.cuda_timing import (bound_ms, device_ms, event_ms,
                                l2_flush_buffer)


def causal_cost(b: int, h: int, hkv: int, s: int, d: int):
    """(FLOPs, bytes, bound ms, bound_by) of one causal forward: the two
    products over the causal (query, key) pairs at 2 FLOP a MAC; q, k, v
    read and out, lse written once."""
    flops = 4.0 * d * h * b * s * (s + 1) / 2
    nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d) + 4 * b * h * s
    return (flops, nbytes, *bound_ms(flops, nbytes))


def bwd_cost(b: int, h: int, hkv: int, s: int, d: int) -> dict:
    """FLOPs and bytes of K3 and K4 at one causal shape, and the least
    time each could take: K3 four products (S, dP, dV, dK) and K4 three
    (S, dP, dQ) over the causal (query, key) pairs at 2 FLOP a MAC; every
    input read once, every output written once."""
    pairs = b * h * s * (s + 1) / 2
    qb, kvb, rowb = 2 * b * h * s * d, 2 * b * hkv * s * d, 4 * b * h * s
    out = {"dkv_flops": 8.0 * d * pairs, "dq_flops": 6.0 * d * pairs,
           "dkv_bytes": 2 * qb + 2 * kvb + 2 * rowb + 2 * kvb,
           "dq_bytes": 2 * qb + 2 * kvb + 2 * rowb + qb}
    for kern in ("dkv", "dq"):
        out[f"{kern}_bound_ms"], out[f"{kern}_bound_by"] = bound_ms(
            out[f"{kern}_flops"], out[f"{kern}_bytes"])
    return out


def _load_cuda_from(root: str, name: str):
    """The ``_cuda`` module of the checkout at ``root``, with its library
    ``name`` built from that checkout's sources into its own build
    directory."""
    spec = importlib.util.spec_from_file_location(
        "profile_k1_against_cuda",
        os.path.join(root, "tpushare_torch", "ops", "_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.library(name)
    return mod


def load_flash_bwd_from(root: str):
    """A launcher of the ``flash_bwd`` library of the checkout at
    ``root``: ``fn(q, k, v, do, lse, dvec) -> (dq, dk, dv)``, causal, no
    window."""
    mod = _load_cuda_from(root, "flash_bwd")

    def run(q, k, v, do, lse, dvec):
        b, h, s, d = q.shape
        dq = torch.empty_like(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        ptrs = [x.data_ptr() for x in (q, k, v, do, lse, dvec)]
        mod.call("flash_bwd", "tpushare_flash_bwd_dkv", *ptrs,
                 dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1], s, d, 1, 0,
                 1.0 / math.sqrt(d))
        mod.call("flash_bwd", "tpushare_flash_bwd_dq", *ptrs, dq.data_ptr(),
                 b, h, k.shape[1], s, d, 1, 0, 1.0 / math.sqrt(d))
        return dq, dk, dv

    return run


def load_flash_fwd_from(root: str):
    """A launcher of the ``flash_fwd`` library of the checkout at ``root``,
    built from that checkout's sources into its own build directory:
    ``fn(q, k, v) -> (out, lse)``, causal, no window."""
    mod = _load_cuda_from(root, "flash_fwd")

    def run(q, k, v):
        b, h, s, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        mod.call("flash_fwd", "tpushare_flash_fwd", q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 b, h, k.shape[1], s, d, 1, 0, 1.0 / math.sqrt(d))
        return out, lse

    return run


def profile_shape(s: int, iters: int, flush, against=None, seed: int = 0,
                  b: int = 1, h: int = 32, hkv: int = 8,
                  d: int = 128) -> dict:
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, n, s, d, generator=g, device="cuda",
                           dtype=torch.bfloat16) for n in (h, hkv, hkv))
    flops, nbytes, bound, by = causal_cost(b, h, hkv, s, d)
    k1 = lambda: attn.flash_attention_lse(q, k, v)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    ms, k1_kernels = device_ms(k1, iters, flush)
    lib_ms, lib_kernels = device_ms(sdpa, iters, flush)
    res = {"B": b, "H": h, "Hkv": hkv, "S": s, "D": d, "causal": True,
           "device_ms": ms, "event_ms": event_ms(k1, iters, flush),
           "library_device_ms": lib_ms,
           "library_event_ms": event_ms(sdpa, iters, flush),
           "library_kernel": sorted(lib_kernels),
           "k1_kernels": sorted(k1_kernels),
           "bound_ms": bound, "bound_by": by, "flops": flops,
           "bytes": nbytes, "tflops": flops / ms / 1e9,
           "bound_share": bound / ms,
           "library_tflops": flops / lib_ms / 1e9}
    if against is not None:
        # both held to the plain version first, then timed in turns
        p_out, p_lse = attn._flash_plain(q, k, v, True, 0)
        for name, fn in (("against", against), ("this", k1)):
            out, lse = fn(q, k, v) if name == "against" else fn()
            res[f"{name}_max_abs_err"] = (out.float() - p_out.float()) \
                .abs().max().item()
            res[f"{name}_lse_max_abs_err"] = (lse - p_lse).abs().max().item()
        del p_out, p_lse
        theirs = lambda: against(q, k, v)  # noqa: E731
        order = [("against", theirs), ("this", k1), ("this", k1),
                 ("against", theirs)]
        res["turns"] = [{"which": name,
                         "device_ms": device_ms(fn, iters, flush)[0]}
                        for name, fn in order]
    return res


def _rel_err(a, ref) -> float:
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def profile_bwd_shape(s: int, iters: int, flush, against=None, seed: int = 0,
                      b: int = 1, h: int = 32, hkv: int = 8,
                      d: int = 128) -> dict:
    """K3's and K4's device times at one causal shape, the port's whole
    backward's and SDPA's backward's (both through autograd, so each
    includes its own dO * O preprocess), their bounds and kernel names;
    with ``against``, that launcher and this checkout's K3 + K4 held to
    the plain version and timed in turns."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(b, h, s, d, generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out, lse = attn.flash_attention_lse(*leaves)
    dvec = (do.float() * out.detach().float()).sum(-1)
    args = (q, k, v, do, lse.detach(), dvec, True, 0)
    dkv = lambda: attn.flash_bwd_dkv(*args)  # noqa: E731
    dq = lambda: attn.flash_bwd_dq(*args)  # noqa: E731
    port = lambda: torch.autograd.grad(  # noqa: E731
        out, leaves, do, retain_graph=True)
    lib_leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*lib_leaves, is_causal=True,
                                           enable_gqa=True)
    lib = lambda: torch.autograd.grad(  # noqa: E731
        o_lib, lib_leaves, do, retain_graph=True)
    res = {"B": b, "H": h, "Hkv": hkv, "S": s, "D": d, "causal": True,
           **bwd_cost(b, h, hkv, s, d)}
    for name, fn in (("dkv", dkv), ("dq", dq), ("backward", port),
                     ("library", lib)):
        res[f"{name}_device_ms"], kernels = device_ms(fn, iters, flush)
        res[f"{name}_event_ms"] = event_ms(fn, iters, flush)
        res[f"{name}_kernels"] = sorted(kernels)
    for kern in ("dkv", "dq"):
        ms = res[f"{kern}_device_ms"]
        res[f"{kern}_tflops"] = res[f"{kern}_flops"] / ms / 1e9
        res[f"{kern}_bound_share"] = res[f"{kern}_bound_ms"] / ms
    res["pair_device_ms"] = res["dkv_device_ms"] + res["dq_device_ms"]
    res["pair_over_library"] = res["pair_device_ms"] / res[
        "library_device_ms"]
    res["backward_over_library"] = res["backward_device_ms"] / res[
        "library_device_ms"]
    if against is not None:
        # both held to the plain version first, then timed in turns
        ref = attn._flash_bwd_plain(*args)
        ours = (dq(), *dkv())
        theirs = against(*args[:6])
        for name, got in (("this", ours), ("against", theirs)):
            res[f"{name}_rel_err"] = {
                n: _rel_err(x, r) for n, x, r in zip(("dq", "dk", "dv"),
                                                     got, ref)}
        del ref, ours, theirs
        mine = lambda: (dkv(), dq())  # noqa: E731
        other = lambda: against(*args[:6])  # noqa: E731
        order = [("against", other), ("this", mine), ("this", mine),
                 ("against", other)]
        res["turns"] = [{"which": name,
                         "device_ms": device_ms(fn, iters, flush)[0]}
                        for name, fn in order]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpushare_torch.profile_k1")
    ap.add_argument("--bwd", action="store_true",
                    help="time K3, K4 and the backwards instead of K1")
    ap.add_argument("--against", default=None,
                    help="root of another checkout whose K1 (K3 + K4 with "
                         "--bwd) is timed in turns with this one at "
                         "S = 2048")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_k1 needs a CUDA device")
    loader, profile, phase = ((load_flash_bwd_from, profile_bwd_shape, "k3k4")
                              if args.bwd else
                              (load_flash_fwd_from, profile_shape, "k1"))
    against = loader(args.against) if args.against else None
    flush = l2_flush_buffer()
    for s in (2048, 8192):
        res = profile(s, 20, flush, against if s == 2048 else None)
        res.update({"phase": phase, "device": torch.cuda.get_device_name(0)})
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
