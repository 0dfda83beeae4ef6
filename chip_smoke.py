#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit.  Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel built from ``tpushare_torch/ops/csrc/*.cu`` by
   ``nvcc`` for ``sm_90a`` (one compiler per source, started together);
   for K1, K3/K4 and K2's prefill arm (the wgmma kernels), ptxas's lines
   of every instantiation (registers, spills, any serialised wgmma: each
   must show 0 bytes of spill and no serialised wgmma) and whether their
   SASS holds ``HGMMA`` (wgmma),
   ``UTMALDG`` and ``UTMASTG`` (TMA), read with ``cuobjdump`` where the
   toolkit has it;
3. K1 (flash forward) against its plain PyTorch version at the serving
   ``/score`` shape (S = 2048, 32 heads over 8 kv heads, D = 128, causal),
   S = 2047 (the forward of a 2048-token ``/score``), a ragged S = 1000,
   a window of 256, D = 64 non-causal, and its tile edges (S around
   multiples of 64 and 128, causal or not, both head dims, GQA ratios
   1, 4 and 8, windows around a key tile); then its own device time and
   ``scaled_dot_product_attention``'s by ``torch.profiler`` at S = 2048
   and S = 8192 (``tpushare_torch.profile_k1``);
4. K2 (paged read) against its plain version at decode (8 rows of
   contexts 100-2000 over shuffled pages of the full Llama-3-8B pool,
   through the decode arm ``csrc/paged_decode.cu``) and at a 2000-token
   prefill window (``csrc/paged_attn.cu``), for the bf16 pool and for
   the int8 store (its own entry points); then K2's striped variants (one
   entry point a store and arm) on each of 2 position stripes of that
   pool, laid out as the batcher lays it, against the plain version (out,
   m, l), and the stripes merged against the unstriped K2 over the same
   keys; each entry point's device time by the profiler with the kernels
   it launched a call and, at decode, the split count the wrapper gave
   the timed launches; then the decode
   arm's edges, all four entry points (a 1-token context, contexts at
   split boundaries +-1 key, a window of 256 whose leading splits are
   empty, a table wider than every context, a stripe whose rows keep no
   key, n_rep 1, 4 and 8, D 64 and 128, B = 1); then the prefill arm's
   edges, all four entry points (the windowed ring's 64-token chunk at
   a context of ~2000, S not a multiple of 128 at n_rep 1 and 8, a
   window that skips whole key tiles, pages of 16, 8, 4, and 6 for the
   bf16 pool, a table of 20,000 entries);
5. K3 + K4 (flash backward, dK/dV and dQ) against their plain version at
   the training shape (B = 1, S = 2048, 32 heads over 8 kv heads,
   D = 128, causal), with an lse cotangent, at a ragged S = 1000 with and
   without a window of 256, D = 64 non-causal, and their tile edges (K1's
   edge S, windows around a tile, n_rep 1, 4 and 8 with and without the
   lse cotangent); then K3's and K4's own device time by the profiler,
   the port's whole backward's (dvec = rowsum(dO * O), K3, K4) and
   SDPA's backward's (its own dO * O preprocess included), at S = 2048
   and S = 8192 (``tpushare_torch.profile_k1 --bwd``);
6. the server: Llama-3-8B at full width and depth with random seeded
   weights, an in-process ``LLMServer`` (8 slots, pages of 16), four
   concurrent ``/generate`` requests and one 2048-token ``/score``; the
   kernels' launch counters are zeroed just before and read just after;
7. agreement: ``flagship-small`` in bf16, the K2 read path against the
   gather path, in f32 and in bf16 (first-step logits and greedy
   streams), and the no-cache forward through K1 against the gather
   path's prefill logits;
8. sp_stripe: Llama-3-8B at full width and depth (bf16 weights) served by
   a ``ContinuousService`` whose pool of 2 x 257 pages is striped over a
   mesh of two shards on the one card (``make_mesh({"sp": 2}, devices=
   [cuda:0, cuda:0])``): the server phase's load plus a 6,000-token
   greedy prompt, which an unstriped pool of 257 pages (the same bytes a
   device) refuses; the counters are zeroed just before and read just
   after (K2's striped variant twice per layer of every paged forward,
   the unstriped K2 never); first-step logits of the greedy prompts
   against an unstriped pool of 700 pages on the same weights; a striped
   and an unstriped decode step's wall; then the same on int8 pools;
9. grant: the server started as a pod is, by ``llm.start_server`` under
   the device plugin's env for a 14 GiB pod on an 80-unit card (the
   allocator capped at the fraction 0.175 before anything is built),
   Llama-3-8B at full width and depth with int8 weights (built one layer
   slice at a time) and a 1 GiB int8 KV pool, the server phase's load;
   checks the int8 K2 in every layer of every paged forward (the bf16
   one never), the peak reserved memory inside the grant, and an
   allocation past the grant refused; then the fraction goes back to 1;
10. train, last, after the serving memory is freed: ``Trainer`` on
    Llama-3-8B at full width and depth (random seeded weights, AdamW,
    ``remat="layer"``, ``head_chunk=512``, lr 3e-4), four steps on one
    seeded [1, 2049] batch; the counters are zeroed just before and read
    after every step (K1, K3 and K4 each once per layer and step).

Then it prints the ``kernels`` line (time on the card, the plain version's
time, one PyTorch library call's time, and the least time the card could
take; K2 a row per arm and entry point, ``paged_attn*`` timed at the
prefill window and ``paged_decode*`` at decode with the redesign's
``stage`` and the split count of its timed launches; ``device_ms``,
the kernel's own time by the
profiler, and for K1
and K3/K4 ``library_device_ms`` and ``library_kernel`` the same of the
library call; for K1, K3 and K4 also ``tflops`` and ``bound_share`` on
their device time, and ``long_*`` at S = 8192; for K3/K4
``backward_device_ms``, the port's whole backward), the
card's name and power limit, and last the result line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
without that line, as does a machine without CUDA or a directory that
holds this script and nothing else of the repository.
"""

import gc
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

#: kernel vs its plain version on the card, bf16 inputs: P is rounded to
#: bf16 before PV in both, so the outputs differ by the accumulation order
#: and the rounding of P relative to a running (kernel) or final (plain)
#: max; the lse is f32 throughout
OUT_TOL = 2e-2
LSE_TOL = 1e-3
#: K3 / K4 vs their plain version, bf16 inputs: both round P and dS to
#: bf16 before the second product, the kernel from an ex2.approx
#: exponential, so an element may land one bf16 step away; each of dQ,
#: dK, dV within this share of the plain version's largest magnitude
BWD_TOL = 2e-2
#: first-step logits of a whole bf16 model (flagship-small) through the K2
#: read path against the same weights in f32 through the gather path; and
#: of Llama-3-8B through the striped read against the unstriped one, or,
#: where a 32-layer model's bf16 noise is larger, 1.25x the distance
#: between the unstriped pool's own two read paths (K2 and the gather)
LOGIT_TOL = 5e-2

SEED = 0

#: the stages of K2's decode-arm redesign that csrc/paged_decode.cu holds
DECODE_STAGE = ("1-3: split-KV over the page table with the combine in the "
                "kernel's tail; every warp on the keys, over non-empty "
                "splits only; int8 dequantized in registers")
#: the stages of K2's prefill-arm redesign that csrc/paged_attn.cu holds
PREFILL_STAGE = ("1-4: 128 packed GQA rows a block, a producer warpgroup "
                 "copying 128-key tiles through the page table by cp.async "
                 "into swizzled stages, two consumer warpgroups on wgmma; "
                 "the int8 store dequantized by the producer; striped")


class PhaseFailed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and line, f"nvidia-smi failed: {smi.stderr}")
    return {"nvidia_smi": line, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build():
    from tpushare_torch.ops import _cuda

    t0 = time.perf_counter()
    took = _cuda.build()
    regs = {}
    for name in _cuda.ENTRY_POINTS:
        log = (_cuda.BUILD_DIR / f"{name}.log")
        text = log.read_text() if log.exists() else ""
        regs[name] = [ln.strip() for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln]
        _cuda.library(name)
    # K1, K3/K4 and K2's prefill arm on Hopper's own paths: wgmma (HGMMA)
    # and TMA (UTMALDG, UTMASTG) in their SASS, and ptxas's lines
    # (registers, spills, any serialised wgmma) for every instantiation
    # (two a kernel of K1 and K3/K4: D 64 and 128; eight of the prefill
    # arm: D, store and striped): no spill, no serialised wgmma
    out = {"seconds": time.perf_counter() - t0, "per_source_s": took,
           "arch": "sm_90a", "ptxas": regs}
    for key, lib, kernels, n in (
            ("k1", "flash_fwd", ("flash_fwd_kernel",), 2),
            ("k3k4", "flash_bwd", ("dkv_kernel", "dq_kernel"), 4),
            ("k2p", "paged_attn", ("paged_prefill_kernel",), 8)):
        report = {fn: lines for fn, lines in _cuda.ptxas_report(lib).items()
                  if any(k in fn for k in kernels)}
        check(len(report) == n, f"{key}'s ptxas report: {report}")
        for fn, lines in report.items():
            text = " ".join(lines)
            check("0 bytes spill stores, 0 bytes spill loads" in text
                  and "serializ" not in text,
                  f"{key}: {fn} spills or serialises its wgmmas: {lines}")
        sass = _cuda.sass_opcodes(lib, ("HGMMA", "UTMALDG", "UTMASTG"))
        if sass is not None:
            check(all(sass.values()), f"{key}'s SASS lacks an opcode: {sass}")
        out[f"{key}_ptxas"] = report
        out[f"{key}_sass"] = (sass if sass is not None
                              else "cuobjdump not in the toolkit")
    return out


def _flash_case(torch, attn, b, h, hkv, s, d, causal, window, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = (lambda *shape: torch.randn(*shape, generator=g, device="cuda",
                                     dtype=torch.bfloat16))
    q, k, v = mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d)
    out, lse = attn.flash_attention_lse(q, k, v, causal=causal,
                                        window=window)
    p_out, p_lse = attn._flash_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    err = (out.float() - p_out.float()).abs().max().item()
    lse_err = (lse - p_lse).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "K1 output not finite")
    check(err <= OUT_TOL and lse_err <= LSE_TOL,
          f"K1 {s=} {d=} {causal=} {window=}: out err {err}, "
          f"lse err {lse_err}")
    return (q, k, v), {"S": s, "D": d, "H": h, "Hkv": hkv, "causal": causal,
                       "window": window, "max_abs_err": err,
                       "lse_max_abs_err": lse_err}


#: K1's tile edges (its blocks own 128 query rows and walk keys 128 at a
#: time): S around multiples of 64 and 128, a lone row, the ragged /score
#: S and the main one, causal and not, both head dims, GQA ratios 1, 4
#: and 8 in turn, B = 2; then windows around a key tile
K1_EDGE_S = (1, 63, 64, 65, 127, 128, 129, 255, 1000, 2047, 2048)
K1_GQA = ((4, 4), (8, 2), (8, 1))
K1_EDGE_CASES = tuple(
    (2, *K1_GQA[i % len(K1_GQA)], s, d, causal, 0)
    for i, s in enumerate(K1_EDGE_S) for d in (64, 128)
    for causal in (True, False)) + tuple(
    (2, 8, 2, s, d, True, w) for w in (1, 127, 128, 129, 256)
    for s in (129, 1000, 2048) for d in (64, 128))


def phase_k1(torch, flush):
    from tpushare_torch import profile_k1
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.utils.cuda_timing import event_ms

    cases = []
    (q, k, v), main = _flash_case(torch, attn, 1, 32, 8, 2048, 128, True,
                                  0, SEED)
    for args in ((1, 32, 8, 2047, 128, True, 0),      # /score's forward
                 (1, 32, 8, 1000, 128, True, 0),      # ragged tail
                 (1, 32, 8, 2048, 128, True, 256),    # sliding window
                 (2, 8, 8, 512, 64, False, 0)):       # D = 64, non-causal
        cases.append(_flash_case(torch, attn, *args, SEED + 1)[1])
    edge_err = edge_lse_err = 0.0
    for i, args in enumerate(K1_EDGE_CASES):
        c = _flash_case(torch, attn, *args, SEED + 100 + i)[1]
        edge_err = max(edge_err, c["max_abs_err"])
        edge_lse_err = max(edge_lse_err, c["lse_max_abs_err"])
    torch.cuda.empty_cache()
    # events around the wrapper (host launch path included) and the plain
    # version, on the main case's inputs
    main["ms"] = event_ms(lambda: attn.flash_attention_lse(q, k, v),
                         20, flush)
    main["plain_ms"] = event_ms(
        lambda: attn._flash_plain(q, k, v, True, 0), 5, flush)
    del q, k, v
    # the kernel's own device time and the library's, by the profiler,
    # at the main shape and at a long /score (S = 8192, no plain version)
    for s, key in ((2048, "main"), (8192, "long")):
        res = profile_k1.profile_shape(s, 20, flush, seed=SEED + 2)
        if key == "main":
            main.update({"device_ms": res["device_ms"],
                         "library_device_ms": res["library_device_ms"],
                         "library_ms": res["library_event_ms"],
                         "library_kernel": res["library_kernel"],
                         "bound_ms": res["bound_ms"],
                         "bound_by": res["bound_by"],
                         "tflops": res["tflops"],
                         "bound_share": res["bound_share"],
                         "library_tflops": res["library_tflops"],
                         "profiled_event_ms": res["event_ms"]})
        else:
            main["long"] = res
        torch.cuda.empty_cache()
    return {"main": main, "cases": cases, "edge_cases": len(K1_EDGE_CASES),
            "edge_max_abs_err": edge_err,
            "edge_lse_max_abs_err": edge_lse_err}


def _paged_case(torch, attn, contexts, s, seed, int8=False):
    """q at the last ``s`` positions of each row's context, over pages of
    a full-size Llama-3-8B layer pool drawn without replacement; with
    ``int8`` the pool is quantized into int8 {"q","s"} stores first."""
    from tpushare_torch import profile_k2

    args = profile_k2.paged_operands(contexts, s, seed, int8=int8)
    out = attn.paged_decode_attention(*args)
    ref = attn._paged_plain(*args, None)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    kind = "int8" if int8 else "bf16"
    check(torch.isfinite(out.float()).all().item(),
          f"K2 ({kind}) output not finite")
    check(err <= OUT_TOL,
          f"K2 ({kind}) contexts={contexts} S={s}: out err {err}")
    # bytes this run's data needs: each row's live K and V once (an int8
    # store: one byte a value plus its key's f32 scale), q, o, the table
    # and positions; operations: QK and PV over the kept (query, key)
    # pairs
    flops, nbytes = profile_k2.read_cost(contexts, s, int8)
    return args, {"store": kind, "contexts": contexts, "S": s,
                  "max_abs_err": err, "flops": flops, "bytes": nbytes}


def _striped_case(torch, attn, contexts, s, seed, int8, sp=2, page=16):
    """K2's striped variant on each of ``sp`` position stripes of a
    full-size Llama-3-8B layer pool laid out as the batcher lays it
    (range j of a row on stripe j % sp, never a stripe's trash page),
    held to the plain version on the stripe's local table and pos_map:
    out within OUT_TOL, m within LSE_TOL, l within LSE_TOL relative; the
    stripes' partials merged (``sp_merge_partials``) held to the
    unstriped K2 over the same keys within OUT_TOL.  Returns stripe 0's
    arguments and the case's numbers, with the bytes and operations of
    stripe 0's launch: the keys its rows keep, and their (query, key)
    pairs."""
    from tpushare_torch import profile_k2

    q, k_pool, v_pool, table, positions, layer, per, mesh = \
        profile_k2.striped_operands(contexts, s, seed, int8=int8, sp=sp)
    outs, ms, ls, errs, args0 = [], [], [], [], None
    for t, (ks, vs) in enumerate(layer):
        tbl, pmap = attn.striped_local_view(table, sp, t, per, page)
        args = (q, ks, vs, tbl, positions)
        o, m, l = attn.paged_decode_attention(*args, pos_map=pmap,
                                              return_stats=True)
        po, pm, pl = attn._paged_plain(*args, None, pos_map=pmap,
                                       return_stats=True)
        torch.cuda.synchronize()
        errs.append({
            "out": (o.float() - po.float()).abs().max().item(),
            "m": (m - pm).abs().max().item(),
            "l_rel": ((l - pl).abs() / pl.clamp_min(1e-30)).max().item(),
            "rows_without_keys": int((pl == 0).sum().item())})
        check(torch.isfinite(o.float()).all().item(),
              f"striped K2 stripe {t} output not finite")
        outs.append(o)
        ms.append(m)
        ls.append(l)
        if t == 0:
            args0 = args + (pmap,)
    kind = "int8" if int8 else "bf16"
    for t, e in enumerate(errs):
        check(e["out"] <= OUT_TOL and e["m"] <= LSE_TOL
              and e["l_rel"] <= LSE_TOL,
              f"striped K2 ({kind}) S={s} stripe {t}: {e}")
    merged = attn.sp_merge_partials(outs, ms, ls, q.device)
    whole = attn.paged_decode_attention(q, k_pool, v_pool, table, positions)
    merge_err = (merged.float() - whole.float()).abs().max().item()
    check(merge_err <= OUT_TOL,
          f"striped K2 ({kind}) S={s}: merged stripes {merge_err} from the "
          f"unstriped K2")
    # stripe 0's launch: the keys of ranges 0, sp, 2sp, ... at or before
    # each row's last position, once; the (query, key) pairs its rows keep
    flops, nbytes = profile_k2.read_cost(contexts, s, int8, sp=sp)
    return args0, {"store": kind, "contexts": contexts, "S": s, "sp": sp,
                   "max_abs_err": max(e["out"] for e in errs),
                   "stripes": errs, "merged_vs_unstriped_err": merge_err,
                   "flops": flops, "bytes": nbytes}


def _time_k2(torch, attn, case, args, kw, iters, plain_iters, flush):
    """K2's times at one case: ms by events around the wrapper, its own
    device time by the profiler (at S = 1 the decode arm's one kernel,
    its splits' fold included) with the kernels it launched a call, the
    plain version's ms (``plain_iters`` 0: not timed), the bound and the
    rate; at S = 1 also the split plan the timed calls were given."""
    from tpushare_torch.utils.cuda_timing import (bound_ms, device_ms,
                                                  event_ms)

    kernel = lambda: attn.paged_decode_attention(*args, **kw)  # noqa: E731
    case["ms"] = event_ms(kernel, iters, flush)
    attn.paged_decode_attention.decode_plan = None
    case["device_ms"], case["kernels"] = device_ms(kernel, iters, flush)
    if case["S"] == 1:
        plan = attn.paged_decode_attention.decode_plan
        check(plan is not None, "K2's timed decode calls left no split plan")
        case["split_pages"], case["n_splits"] = plan
    if plain_iters:
        case["plain_ms"] = event_ms(
            lambda: attn._paged_plain(*args, None, **kw), plain_iters, flush)
    case["bound_ms"], case["bound_by"] = bound_ms(case["flops"],
                                                  case["bytes"])
    case["gbps"] = case["bytes"] / case["ms"] / 1e6


def _k2_edges(torch, attn, cases, arm: str, seed: int):
    """Every K2 entry point of one arm against the plain version at
    ``cases`` ((contexts, S, window, n_rep, d, page, n_tbl), q at each
    row's last S positions; the int8 entry points where the page is a
    multiple of 4), on a pool of 600 pages with 2 kv heads, striped as
    the batcher stripes it: out within OUT_TOL; striped, each stripe's m
    within LSE_TOL and l within LSE_TOL relative, and a row that keeps no
    key of a stripe out 0, m NEG_INF and l 0 exactly; every call one
    launch of its entry point of ``arm`` (``"_decode"`` or ``""``, the
    prefill arm)."""
    from tpushare_torch import profile_k2

    worst = {"out": 0.0, "m": 0.0, "l_rel": 0.0}
    empty_rows = calls = 0
    k2 = attn.paged_decode_attention
    for i, (contexts, s, window, n_rep, d, page, n_tbl) in enumerate(cases):
        for int8 in (False, True) if page % 4 == 0 else (False,):
            q, kp, vp, table, pos, stripes, per, _ = \
                profile_k2.striped_operands(
                    contexts, s, seed + i, int8=int8, n_pages=600, hkv=2,
                    h=2 * n_rep, d=d, page=page, n_tbl=n_tbl)
            kind = "_int8" if int8 else ""
            what = (f"K2{kind} edge {contexts} S={s} {window=} {n_rep=} "
                    f"{d=} {page=}")
            counter = f"launches{arm}{kind}"
            before = getattr(k2, counter)
            out = k2(q, kp, vp, table, pos, window=window)
            ref = attn._paged_plain(q, kp, vp, table, pos, window)
            torch.cuda.synchronize()
            calls += 1
            err = (out.float() - ref.float()).abs().max().item()
            check(getattr(k2, counter) == before + 1,
                  f"{what} did not run its arm")
            check(torch.isfinite(out.float()).all().item() and
                  err <= OUT_TOL, f"{what}: out err {err}")
            worst["out"] = max(worst["out"], err)
            for t, (sk, sv) in enumerate(stripes):
                tbl, pmap = attn.striped_local_view(table, 2, t, per, page)
                before = getattr(k2, counter + "_striped")
                o, m, l = k2(q, sk, sv, tbl, pos, window=window,
                             pos_map=pmap, return_stats=True)
                po, pm, pl = attn._paged_plain(q, sk, sv, tbl, pos, window,
                                               pos_map=pmap,
                                               return_stats=True)
                torch.cuda.synchronize()
                calls += 1
                e = {"out": (o.float() - po.float()).abs().max().item(),
                     "m": (m - pm).abs().max().item(),
                     "l_rel": ((l - pl).abs() / pl.clamp_min(1e-30))
                     .max().item()}
                none = pl == 0
                check(getattr(k2, counter + "_striped") == before + 1
                      and e["out"] <= OUT_TOL and e["m"] <= LSE_TOL
                      and e["l_rel"] <= LSE_TOL
                      and bool((l[none] == 0).all())
                      and bool((m[none] == attn.NEG_INF).all())
                      and bool((o[none] == 0).all()),
                      f"striped {what} stripe {t}: {e}")
                empty_rows += int(none.sum())
                worst = {k: max(v, e[k]) for k, v in worst.items()}
            torch.cuda.empty_cache()
    return {"cases": len(cases), "calls": calls, "max_err": worst,
            "stripe_rows_without_keys": empty_rows}


def _k2_decode_edges(torch, attn):
    """The decode arm (S = 1) at ``profile_k2.DECODE_EDGES``, pages of 16
    and tables of 160 entries (``_k2_edges``); some stripe row keeps no
    key."""
    from tpushare_torch import profile_k2

    res = _k2_edges(torch, attn, [
        (contexts, 1, window, n_rep, d, 16, 160)
        for contexts, window, n_rep, d in profile_k2.DECODE_EDGES],
        "_decode", SEED + 300)
    check(res["stripe_rows_without_keys"] > 0,
          "no decode edge left a stripe row without keys")
    return res


def _k2_prefill_edges(torch, attn):
    """The prefill arm (S > 1) at ``profile_k2.PREFILL_EDGES``
    (``_k2_edges``)."""
    from tpushare_torch import profile_k2

    return _k2_edges(torch, attn, profile_k2.PREFILL_EDGES, "", SEED + 400)


def phase_k2(torch, flush):
    """The bf16 pool and the int8 store, each at decode and at a
    2000-token prefill window, unstriped and on 2 position stripes; then
    the decode arm's edges (``_k2_decode_edges``) and the prefill arm's
    (``_k2_prefill_edges``)."""
    from tpushare_torch.ops import attention as attn

    contexts = [100, 371, 642, 913, 1184, 1455, 1726, 2000]
    res = {}
    for int8 in (False, True):
        prefix = "int8_" if int8 else ""
        args, dec = _striped_case(torch, attn, contexts, 1, SEED + 4, int8)
        kw = {"pos_map": args[5], "return_stats": True}
        _time_k2(torch, attn, dec, args[:5], kw, 50, 5, flush)
        del args
        args, pre = _striped_case(torch, attn, [2000], 2000, SEED + 5, int8)
        kw = {"pos_map": args[5], "return_stats": True}
        _time_k2(torch, attn, pre, args[:5], kw, 10, 3, flush)
        del args
        torch.cuda.empty_cache()
        res.update({prefix + "striped_decode": dec,
                    prefix + "striped_prefill": pre})
    for int8 in (False, True):
        args, dec = _paged_case(torch, attn, contexts, 1, SEED + 2,
                                int8=int8)
        _time_k2(torch, attn, dec, args, {}, 50, 5, flush)
        del args
        pargs, pre = _paged_case(torch, attn, [2000], 2000, SEED + 3,
                                 int8=int8)
        _time_k2(torch, attn, pre, pargs, {}, 10, 3, flush)
        del pargs
        torch.cuda.empty_cache()
        prefix = "int8_" if int8 else ""
        res.update({prefix + "decode": dec, prefix + "prefill": pre})
    res["decode_edges"] = _k2_decode_edges(torch, attn)
    res["prefill_edges"] = _k2_prefill_edges(torch, attn)
    return res


def _bwd_case(torch, attn, b, h, hkv, s, d, causal, window, g_lse, seed):
    """K3 and K4 on random bf16 q, k, v, dO, the plain forward's lse and
    dvec = rowsum(dO * O) (minus a random lse cotangent), against
    ``_flash_bwd_plain`` on the same inputs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = (lambda *shape: torch.randn(*shape, generator=g, device="cuda",
                                     dtype=torch.bfloat16))
    q, k, v, do = mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d), \
        mk(b, h, s, d)
    out, lse = attn._flash_plain(q, k, v, causal, window)
    dvec = (do.float() * out.float()).sum(-1)
    if g_lse:
        dvec = dvec - torch.randn(b, h, s, generator=g, device="cuda")
    args = (q, k, v, do, lse.contiguous(), dvec.contiguous(), causal, window)
    dk, dv = attn.flash_bwd_dkv(*args)
    dq = attn.flash_bwd_dq(*args)
    ref = attn._flash_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        check(torch.isfinite(got.float()).all().item(),
              f"K3/K4 {name} not finite")
        errs[name] = ((got.float() - want.float()).abs().max()
                      / want.float().abs().max()).item()
    check(max(errs.values()) <= BWD_TOL,
          f"K3/K4 {s=} {d=} {causal=} {window=} {g_lse=}: relative errors "
          f"{errs}")
    return args, {"S": s, "D": d, "H": h, "Hkv": hkv, "causal": causal,
                  "window": window, "lse_cotangent": g_lse,
                  "rel_err": errs,
                  "max_abs_err": {"dq": (dq.float() - ref[0].float()).abs()
                                  .max().item(),
                                  "dk": (dk.float() - ref[1].float()).abs()
                                  .max().item(),
                                  "dv": (dv.float() - ref[2].float()).abs()
                                  .max().item()}}


#: K3/K4's tile edges, as ``tests/test_torch_cuda.py`` holds them (K3's
#: blocks own 64 keys and walk q tiles of 64, K4's own 128 queries and
#: walk key tiles of 64): K1's edge S causal or not, both head dims, GQA
#: ratios in turn, the lse cotangent at D = 64; windows around a tile;
#: n_rep 1, 4 and 8 with and without the lse cotangent.  Where each query
#: sees one key (S = 1, window 1) dS cancels to rounding noise, so those
#: cases carry the lse cotangent.
K3K4_EDGE_CASES = tuple(
    (2, *K1_GQA[i % len(K1_GQA)], s, d, causal, 0, d == 64 or s == 1)
    for i, s in enumerate(K1_EDGE_S) for d in (64, 128)
    for causal in (True, False)) + tuple(
    (2, 8, 2, s, d, True, w, w == 1) for w in (1, 127, 128, 129, 256)
    for s in (129, 1000, 2048) for d in (64, 128)) + tuple(
    (2, 8, hkv, 1000, 128, True, 0, g_lse) for hkv in (8, 2, 1)
    for g_lse in (False, True))


def phase_k3k4(torch, flush):
    from tpushare_torch import profile_k1
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.utils.cuda_timing import event_ms

    cases = []
    args, main = _bwd_case(torch, attn, 1, 32, 8, 2048, 128, True, 0, False,
                           SEED + 10)
    for case in ((1, 32, 8, 2048, 128, True, 0, True),    # lse cotangent
                 (1, 32, 8, 1000, 128, True, 0, False),   # ragged tail
                 (1, 32, 8, 1000, 128, True, 256, False),  # + window
                 (2, 8, 8, 512, 64, False, 0, False)):    # D = 64
        cases.append(_bwd_case(torch, attn, *case, SEED + 11)[1])
    edge_err = 0.0
    for i, case in enumerate(K3K4_EDGE_CASES):
        c = _bwd_case(torch, attn, *case, SEED + 200 + i)[1]
        edge_err = max(edge_err, *c["rel_err"].values())
    main["plain_ms"] = event_ms(lambda: attn._flash_bwd_plain(*args),
                               3, flush)
    del args
    torch.cuda.empty_cache()
    # by the profiler: K3, K4, the port's whole backward and SDPA's
    # backward (the library yardstick, its dO * O preprocess included),
    # at the training shape and at S = 8192 (no plain version there)
    for s, key in ((2048, "main"), (8192, "long")):
        res = profile_k1.profile_bwd_shape(s, 20, flush, seed=SEED + 12)
        if key == "main":
            main.update({k: v for k, v in res.items()
                         if k not in ("B", "H", "Hkv", "S", "D", "causal")})
            main.update({"dkv_ms": res["dkv_event_ms"],
                         "dq_ms": res["dq_event_ms"],
                         "library_ms": res["library_event_ms"],
                         "library_kernel": res["library_kernels"]})
        else:
            main["long"] = res
        torch.cuda.empty_cache()
    return {"main": main, "cases": cases,
            "edge_cases": len(K3K4_EDGE_CASES),
            "edge_max_rel_err": edge_err}


def _post(port, path, body, timeout=900):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.read().decode()


def _check_llama3_8b(cfg) -> None:
    check(cfg.d_model == 4096 and cfg.n_layers == 32 and cfg.vocab == 128256
          and cfg.n_kv_heads == 8 and cfg.d_ff == 14336,
          "llama3-8b config is not full width and depth")


def _drive_server(port: int, cfg) -> dict:
    """The serving load of the server and grant phases, through HTTP:
    four concurrent ``/generate`` (prompts of 256/512/1000/2000 tokens,
    32 new each, the last sampled), then one 2048-token ``/score``.  The
    kernels' launch counters are zeroed just before and read just after;
    every response is checked for form."""
    import math

    import numpy as np

    from tpushare_torch.ops import attention as attn

    rng = np.random.default_rng(SEED)
    lens = [256, 512, 1000, 2000]
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    reqs = [{"tokens": [p], "max_new_tokens": 32} for p in prompts]
    reqs[3].update({"temperature": 0.8, "top_k": 50, "seed": 7})
    score_row = rng.integers(0, cfg.vocab, 2048).tolist()

    k2 = attn.paged_decode_attention
    attn.flash_attention_lse.launches = 0
    for kind in attn.K2_KINDS:
        setattr(k2, f"launches{kind}", 0)
        setattr(k2, f"launches_decode{kind}", 0)
    results = [None] * len(reqs)

    def send(i):
        try:
            results[i] = _post(port, "/generate", reqs[i])
        except Exception as e:      # reported below
            results[i] = (None, repr(e))

    t1 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    gen_wall = time.perf_counter() - t1
    t2 = time.perf_counter()
    s_code, s_body = _post(port, "/score", {"tokens": [score_row]})
    score_s = time.perf_counter() - t2
    launches = {"flash_fwd": attn.flash_attention_lse.launches}
    for kind in attn.K2_KINDS:
        launches[f"paged_attn{kind}"] = getattr(k2, f"launches{kind}")
        launches[f"paged_decode{kind}"] = getattr(k2,
                                                  f"launches_decode{kind}")
    h_code, h_body = _get(port, "/healthz")
    _, stats = _get(port, "/stats")
    stats = json.loads(stats)

    for i, (code, body) in enumerate(results):
        check(code == 200, f"/generate {i} failed: {body}")
        row = body["tokens"][0]
        check(row[:lens[i]] == prompts[i] and len(row) == lens[i] + 32,
              f"/generate {i}: malformed tokens (len {len(row)})")
        check(all(0 <= t < cfg.vocab for t in row), "token out of vocab")
    check(s_code == 200, f"/score failed: {s_body}")
    lp = s_body["scores"][0]["logprobs"]
    check(len(lp) == 2047 and all(math.isfinite(x) and x <= 0 for x in lp),
          "/score logprobs malformed or not finite")
    check(h_code == 200, f"/healthz {h_code}: {h_body}")
    b = stats["batcher"]
    check(launches["flash_fwd"] >= cfg.n_layers,
          f"K1 launched {launches['flash_fwd']} times on the main path")
    return {"generate_wall_s": gen_wall,
            "tokens_per_s": 32 * len(reqs) / gen_wall,
            "ttft_s": stats["ttft_s"], "score_s": score_s,
            "prefills": b["prefills"], "decode_steps": b["decode_steps"],
            "forwards": b["prefills"] + b["decode_steps"],
            "launches": launches, "kv_storage": stats["kv_storage"],
            "sampled_tokens": results[3][1]["tokens"][0][lens[3]:]}


def _check_k2_arms(res, kind: str, n_layers: int) -> None:
    """K2 of the pool's kind (``""`` or ``"_int8"``) in every layer of
    every paged forward: the S > 1 arm (``paged_attn``) in every prefill,
    the decode arm (``paged_decode``) in every decode step; no other K2
    entry point."""
    got = res["launches"]
    pre, dec = got[f"paged_attn{kind}"], got[f"paged_decode{kind}"]
    check(pre + dec >= n_layers * res["forwards"] and pre > 0 and dec > 0,
          f"K2{kind} launched {pre} (S > 1) + {dec} (decode) times for "
          f"{res['forwards']} forwards")
    check(dec >= n_layers * res["decode_steps"],
          f"K2{kind}'s decode arm launched {dec} times for "
          f"{res['decode_steps']} decode steps")
    others = {k: n for k, n in got.items() if k.startswith("paged_")
              and k not in (f"paged_attn{kind}", f"paged_decode{kind}")}
    check(not any(others.values()), f"another K2 entry point ran: {others}")


def phase_server(torch, card: str):
    from tpushare_torch.models.transformer import param_count
    from tpushare_torch.serving.llm import LLMServer, build_model

    t0 = time.perf_counter()
    cfg, params = build_model("llama3-8b", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _check_llama3_8b(cfg)
    srv = LLMServer(cfg, params, port=0, n_slots=8, page_size=16,
                    device="cuda").start()
    try:
        res = _drive_server(srv.port, cfg)
    finally:
        srv.stop()
    _check_k2_arms(res, "", cfg.n_layers)
    res.update({"model": "llama3-8b", "card": card,
                "params_b": param_count(params) / 1e9, "init_s": init_s,
                "kv_pool_bytes": res.pop("kv_storage")["pool_bytes"],
                "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return res


#: the device plugin's allocation env for a 14 GiB pod on an 80 GiB card
GRANT_ENV = {"ALIYUN_COM_TPU_MEM_IDX": "0", "ALIYUN_COM_TPU_MEM_POD": "14",
             "ALIYUN_COM_TPU_MEM_DEV": "80",
             "XLA_PYTHON_CLIENT_MEM_FRACTION": "0.175"}
#: the grant phase's int8 KV pool (992 pages of 16 tokens; the same bytes
#: buy 512 bf16 pages)
GRANT_POOL_BYTES = 1 << 30


def phase_grant(torch, card: str):
    """Llama-3-8B at full width and depth, int8 weights and an int8 KV
    pool, served inside a 14 GiB grant: started by the server's own
    start-up (``llm.start_server``: contract, then the allocator capped at
    the granted fraction, then a model built one layer slice at a time),
    driven by the server phase's load.  Checks that the int8 K2 ran in
    every paged forward's every layer and the bf16 one never, that the
    peak reserved memory stayed inside the grant, and that the allocator
    refuses an allocation past it; then restores the whole card."""
    from tpushare_torch.ops.quant import hbm_bytes
    from tpushare_torch.runtime import contract
    from tpushare_torch.serving import llm

    args = llm.parse_args([
        "--model", "llama3-8b", "--int8", "--kv-dtype", "int8",
        "--slots", "8", "--page-size", "16",
        "--kv-pool-bytes", str(GRANT_POOL_BYTES), "--port", "0",
        "--device", "cuda"])
    gc.collect()
    torch.cuda.empty_cache()
    reserved_before = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = llm.start_server(args, env=GRANT_ENV).start()
    try:
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = srv.cfg
        _check_llama3_8b(cfg)
        check(cfg.kv_dtype == "int8" and isinstance(
            srv.params["layers"]["wq"], dict), "the model is not int8")
        weights_bytes = hbm_bytes(srv.params)
        res = _drive_server(srv.port, cfg)
        torch.cuda.synchronize()
        peak_reserved = torch.cuda.max_memory_reserved()
        peak_allocated = torch.cuda.max_memory_allocated()
        budget = contract.verify_budget("cuda", GRANT_ENV)
        check(budget is not None and budget["enforced"],
              f"the grant is not enforced: {budget}")
        grant = budget["grant_bytes"]
        # one allocation that would take the process past the grant: the
        # cache emptied first, so the request cannot land in memory that
        # is reserved but free, and sized from the live allocations
        torch.cuda.empty_cache()
        reserved_after = torch.cuda.memory_reserved()
        over = grant - torch.cuda.memory_allocated() + (1 << 30)
        try:
            torch.empty(over, dtype=torch.uint8, device="cuda")
            refused = False
        except torch.OutOfMemoryError:
            refused = True
    finally:
        srv.stop()
        torch.cuda.set_per_process_memory_fraction(1.0)
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    _check_k2_arms(res, "_int8", cfg.n_layers)
    check(peak_reserved <= grant,
          f"peak reserved {peak_reserved} past the grant {grant}")
    check(refused, f"an allocation of {over} bytes past the grant "
                   f"was not refused")
    kv = res.pop("kv_storage")
    check(kv["kv_dtype"] == "int8" and kv["pool_bytes"] <= GRANT_POOL_BYTES,
          f"kv storage {kv}")
    res.update({"model": "llama3-8b", "card": card, "weights": "int8",
                "kv_dtype": "int8", "init_s": init_s, "env": GRANT_ENV,
                "grant_bytes": grant, "limit_bytes": budget["limit_bytes"],
                "reserved_before_bytes": reserved_before,
                "peak_reserved_bytes": peak_reserved,
                "peak_allocated_bytes": peak_allocated,
                "weights_bytes": weights_bytes,
                "kv_pool_bytes": kv["pool_bytes"], "kv_pages": kv["n_pages"],
                "kv_bytes_per_page": kv["bytes_per_page"],
                "reserved_after_serving_bytes": reserved_after,
                "over_grant_refused_bytes": over})
    return res


def phase_agreement(torch):
    import dataclasses

    import numpy as np

    from tpushare_torch.models import transformer as tf
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    cfg = tf.flagship_small()
    params = tf.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (37, 120, 300)]

    def first_logits(c, p):
        b = PagedContinuousBatcher(p, c, n_slots=1, page_size=16,
                                   device="cuda")
        check(b._reserve(0, len(prompts[0]), 1), "no pages")
        return b._prefill_into(0, prompts[0]).float()

    # the same weights in f32 through the gather path: the yardstick both
    # bf16 read paths are measured against
    p32 = {k: v.float() for k, v in params.items() if k != "layers"}
    p32["layers"] = {k: v.float() for k, v in params["layers"].items()}
    ref32 = first_logits(dataclasses.replace(
        cfg, dtype=torch.float32, attn_kernel="gather"), p32)
    del p32
    first = {}
    streams = {}
    for kind in ("kernel", "gather"):
        c = dataclasses.replace(cfg, attn_kernel=kind)
        first[kind] = first_logits(c, params)
        b2 = PagedContinuousBatcher(params, c, n_slots=3, page_size=16,
                                    device="cuda")
        rids = [b2.admit(p, 16) for p in prompts]
        b2.run_until_drained()
        streams[kind] = [b2.completed[r][len(p):]
                         for r, p in zip(rids, prompts)]
    # the no-cache forward through K1: last-position logits of the prompt
    toks = torch.tensor([prompts[0]], device="cuda")
    before = attn.flash_attention_lse.launches
    with torch.inference_mode():
        first["k1_forward"] = tf.forward(params, toks, cfg)[0, -1]
    check(attn.flash_attention_lse.launches == before + cfg.n_layers,
          "forward did not run K1 in every layer")
    # Every bf16 path sits ~5e-2 from the f32 model on these logits
    # (|logit| <= 4): bf16 noise through four layers, not the read path.
    # So the kernel paths are held to the f32 gather within LOGIT_TOL, and
    # to be no less faithful than the bf16 gather path (25% slack).
    to32 = {k: (v - ref32).abs().max().item() for k, v in first.items()}
    for arm in ("kernel", "k1_forward"):
        check(to32[arm] <= LOGIT_TOL,
              f"{arm} logits {to32[arm]} from the f32 gather path")
        check(to32[arm] <= 1.25 * to32["gather"],
              f"{arm} {to32[arm]} vs bf16 gather {to32['gather']} from "
              f"the f32 model")
    agree = np.mean([a == b for sa, sb in zip(streams["kernel"],
                                              streams["gather"])
                     for a, b in zip(sa, sb)])
    return {"model": "flagship-small",
            "kernel_vs_gather_max_abs_err":
                (first["kernel"] - first["gather"]).abs().max().item(),
            "vs_f32_max_abs_err": to32,
            "f32_logit_absmax": ref32.abs().max().item(),
            "greedy_token_agreement": float(agree),
            "streams_kernel": streams["kernel"],
            "streams_gather": streams["gather"]}


#: the sp_stripe phase's pool: 2 stripes of 257 pages, each 256 usable
#: pages (4,096 tokens) and its trash page
SP_PAGES_PER_STRIPE = 257
#: its long prompt: 6,032 tokens with the new ones, 377 pages, more than
#: one stripe's (or an unstriped pool of the same bytes a device) holds
SP_LONG_PROMPT = 6000


def _first_logits(b, prompts):
    """Each prompt's first-step logits through batcher ``b``'s own pool
    (slot 0, its pages reserved and released around the prefill)."""
    out = []
    for p in prompts:
        check(b._reserve(0, len(p), 1), "no pages for a first-step prefill")
        out.append(b._prefill_into(0, p).float())
        b._release(0)
    return out


def _decode_step_ms(torch, b, prompts, steps=8) -> float:
    """Median wall of ``steps`` decode ticks of batcher ``b`` with one
    greedy request a prompt in flight (two warm-up ticks first)."""
    import numpy as np

    for p in prompts:
        check(b.admit(p, steps + 3) is not None, "decode-step admission")
    walls = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.tick()
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    b.run_until_drained()
    return float(np.median(walls))


def phase_sp_stripe(torch, card: str):
    """Position-striped serving of Llama-3-8B at full width and depth:
    a ``ContinuousService`` over a pool of 2 x 257 pages striped on a
    mesh of two shards on this one card serves the server phase's four
    requests and a 6,000-token greedy prompt that an unstriped pool of
    257 pages (the bytes of one stripe) refuses.  The launch counters are
    zeroed just before the load and read just after: K2's striped
    variant twice per layer of every paged forward, the unstriped K2
    never.  The greedy prompts' first-step logits are held to an
    unstriped pool of 700 pages on the same weights.  Then the same on
    int8 pools."""
    import dataclasses

    import numpy as np

    from tpushare_torch.ops import attention as attn
    from tpushare_torch.parallel.mesh import make_mesh
    from tpushare_torch.serving.continuous import ContinuousService
    from tpushare_torch.serving.llm import build_model
    from tpushare_torch.serving.paged import PagedContinuousBatcher

    cfg, params = build_model("llama3-8b", seed=SEED, device="cuda")
    _check_llama3_8b(cfg)
    mesh = make_mesh({"sp": 2}, devices=["cuda:0", "cuda:0"])
    rng = np.random.default_rng(SEED + 11)
    lens = [256, 512, 1000, 2000, SP_LONG_PROMPT]
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    sampled = {"temperature": 0.8, "top_k": 50, "seed": 7}
    greedy = [0, 1, 2, 4]
    k2 = attn.paged_decode_attention
    counters = tuple(f"launches{arm}{kind}" for arm in ("", "_decode")
                     for kind in attn.K2_KINDS)
    res = {"model": "llama3-8b", "card": card, "sp": 2,
           "devices": [str(d) for d in mesh.devices],
           "pages_per_stripe": SP_PAGES_PER_STRIPE}

    single = PagedContinuousBatcher(params, cfg, n_slots=8, page_size=16,
                                    n_pages=SP_PAGES_PER_STRIPE,
                                    device="cuda")
    try:
        single.validate_request(prompts[4], 32)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None, "an unstriped pool of one stripe's pages "
                               "took the 6,000-token prompt")
    res["unstriped_refusal"] = refusal
    del single
    torch.cuda.empty_cache()

    for kv in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_dtype=kv)
        svc = ContinuousService(params, c, 8, page_size=16,
                                n_pages=2 * SP_PAGES_PER_STRIPE, mesh=mesh)
        b = svc._batcher
        info = svc.storage_info()
        check(info["sp_shards"] == 2
              and info["n_pages"] == 2 * SP_PAGES_PER_STRIPE,
              f"striped storage {info}")
        svc.validate(prompts[4], 32)       # the striped pool takes it
        svc.start()
        try:
            for name in counters:
                setattr(k2, name, 0)
            t0 = time.perf_counter()
            sinks = [svc.submit(p, 32, **(sampled if i == 3 else {}))
                     for i, p in enumerate(prompts)]
            outs = [s.get(timeout=600) for s in sinks]
            wall = time.perf_counter() - t0
            launches = {name: getattr(k2, name) for name in counters}
            snap = svc.snapshot()
            timings = list(svc.timings)
        finally:
            svc.stop()
        for i, o in enumerate(outs):
            check(isinstance(o, list) and o[:lens[i]] == prompts[i]
                  and len(o) == lens[i] + 32
                  and all(0 <= t < cfg.vocab for t in o),
                  f"sp_stripe {kv}: request {i} came back {str(o)[:200]}")
        forwards = snap["prefills"] + snap["decode_steps"]
        kind = "_int8_striped" if kv == "int8" else "_striped"
        mine = (f"launches{kind}", f"launches_decode{kind}")
        check(launches[mine[0]] + launches[mine[1]]
              == 2 * cfg.n_layers * forwards and forwards > 0
              and launches[mine[1]] >= 2 * cfg.n_layers
              * snap["decode_steps"] and launches[mine[0]] > 0,
              f"sp_stripe {kv}: {launches} for {forwards} forwards")
        check(all(n == 0 for name, n in launches.items()
                  if name not in mine),
              f"sp_stripe {kv}: another K2 entry point ran: {launches}")

        ref = PagedContinuousBatcher(params, c, n_slots=8, page_size=16,
                                     n_pages=700, device="cuda")
        greedy_prompts = [prompts[i] for i in greedy]
        want = _first_logits(ref, greedy_prompts)
        got = _first_logits(b, greedy_prompts)
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        check(all(torch.isfinite(g).all().item() for g in got),
              f"sp_stripe {kv}: logits not finite")
        # the bf16 noise of this model: the unstriped pool's two read
        # paths (K2 and the gather) on the same weights and prompts
        gather = PagedContinuousBatcher(
            params, dataclasses.replace(c, attn_kernel="gather"), n_slots=1,
            page_size=16, n_pages=700, device="cuda")
        noise = [(g - w).abs().max().item() for g, w in
                 zip(_first_logits(gather, greedy_prompts), want)]
        del gather
        torch.cuda.empty_cache()
        check(max(errs) <= max(LOGIT_TOL, 1.25 * max(noise)),
              f"sp_stripe {kv}: first-step logits {errs} from the unstriped "
              f"pool, past LOGIT_TOL and 1.25x the unstriped read paths' "
              f"own distance {noise}")
        step_prompts = [prompts[i] for i in range(4)]
        step = {"striped": _decode_step_ms(torch, b, step_prompts),
                "unstriped": _decode_step_ms(torch, ref, step_prompts)}
        ttfts = [t["ttft_s"] for t in timings]
        res[kv] = {"launches": launches, "forwards": forwards,
                   "prefills": snap["prefills"],
                   "decode_steps": snap["decode_steps"],
                   "generate_wall_s": wall,
                   "tokens_per_s": 32 * len(prompts) / wall,
                   "ttft_s": {"mean": float(np.mean(ttfts)),
                              "max": float(np.max(ttfts))},
                   "first_logit_max_abs_err": errs,
                   "unstriped_kernel_vs_gather_max_abs_err": noise,
                   "logit_absmax": max(w.abs().max().item() for w in want),
                   "decode_step_ms": step,
                   "pool_bytes": info["pool_bytes"],
                   "pool_bytes_per_shard": info["pool_bytes_per_shard"],
                   "sampled_tokens": outs[3][lens[3]:]}
        del svc, b, ref
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _all_finite(torch, t) -> bool:
    flat = t.detach().view(-1)
    step = 1 << 26
    return all(torch.isfinite(flat[i:i + step]).all().item()
               for i in range(0, flat.numel(), step))


def phase_train(torch, card: str):
    import numpy as np

    from tpushare_torch.models import transformer as tf
    from tpushare_torch.ops import attention as attn
    from tpushare_torch.parallel.train import tree_leaves
    from tpushare_torch.parallel.trainer import Trainer
    from tpushare_torch.utils.cuda_timing import PEAK_BF16_FLOPS

    cfg = tf.llama3_8b()
    b, s, n_steps = 1, 2048, 4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    trainer = Trainer(cfg, lr=3e-4, seed=SEED, remat="layer",
                      head_chunk=512, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    static_gb = torch.cuda.memory_allocated() / 1e9
    tokens = torch.as_tensor(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab, (b, s + 1)), device="cuda")
    kernels = (attn.flash_attention_lse, attn.flash_bwd_dkv,
               attn.flash_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    losses, walls, per_step = [], [], []
    for _ in range(n_steps):
        before = [fn.launches for fn in kernels]
        t1 = time.perf_counter()
        losses.append(trainer.run(iter([tokens]), 1))   # reads the loss
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        per_step.append([fn.launches - n for fn, n in zip(kernels, before)])
    launches = [fn.launches for fn in kernels]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    n = cfg.n_layers
    check(all(np.isfinite(losses)), f"train losses not finite: {losses}")
    check(losses[-1] < losses[0], f"train loss did not descend: {losses}")
    for i, (k1, k3, k4) in enumerate(per_step):
        check(k3 == n and k4 == n,
              f"step {i}: K3 launched {k3}, K4 {k4} times, not {n}")
        # remat="layer" saves K1's out and lse: no relaunch in the recompute
        check(k1 == n, f"step {i}: K1 launched {k1} times, not {n}")
    check(all(_all_finite(torch, p) for p in tree_leaves(trainer.params)),
          "a parameter is not finite after the steps")
    wall = float(np.median(walls[1:]))
    # model FLOPs as drives/drive_train_mfu.py counts them: 3x the
    # forward, causal attention, the LM head included
    d, ff = cfg.d_model, cfg.d_ff
    per_tok = n * (2 * (4 * d * d + 3 * d * ff) + 2 * 2 * (s // 2) * d) \
        + 2 * d * cfg.vocab
    model_flops = 3.0 * b * s * per_tok
    del trainer
    torch.cuda.empty_cache()
    return {"model": "llama3-8b", "card": card, "layers": n,
            "batch": [b, s + 1], "remat": "layer", "head_chunk": 512,
            "init_s": init_s, "losses": losses, "step_walls_s": walls,
            "step_wall_s": wall, "tokens_per_s": b * s / wall,
            "model_tflop_per_step": model_flops / 1e12,
            "mfu_bf16": model_flops / wall / PEAK_BF16_FLOPS,
            "allocated_before_gb": before_gb, "static_gb": static_gb,
            "peak_memory_gb": peak_gb,
            "peak_reserved_gb": reserved_gb,
            "launches_per_step": {"flash_fwd": per_step[0][0],
                                  "flash_bwd_dkv": per_step[0][1],
                                  "flash_bwd_dq": per_step[0][2]},
            "launches": {"flash_fwd": launches[0],
                         "flash_bwd_dkv": launches[1],
                         "flash_bwd_dq": launches[2]}}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tpushare_torch")):
        print("chip_smoke.py: the tpushare_torch package is not beside "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # the train phase holds ~65 GB of params, grads and moments beside
    # transient GBs of differing sizes: growable segments keep the cache
    # from fragmenting (read when CUDA first initialises)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    out = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            res = fn(*args)
        except Exception as e:
            emit({"phase": name, "ok": False, "error": repr(e),
                  "traceback": traceback.format_exc()[-3000:]})
            raise PhaseFailed(name) from e
        res = dict(res)
        res.update({"phase": name, "ok": True,
                    "phase_s": time.perf_counter() - t0})
        emit(res)
        out[name] = res
        return res

    try:
        dev = run("device", phase_device, torch)
        run("build", phase_build)
        from tpushare_torch.utils.cuda_timing import l2_flush_buffer
        flush = l2_flush_buffer()
        k1 = run("k1_flash_fwd", phase_k1, torch, flush)
        k2 = run("k2_paged_attn", phase_k2, torch, flush)
        k34 = run("k3k4_flash_bwd", phase_k3k4, torch, flush)
        del flush
        torch.cuda.empty_cache()
        srv = run("server", phase_server, torch, dev["nvidia_smi"])
        torch.cuda.empty_cache()
        run("agreement", phase_agreement, torch)
        # the serving phases' model and pool sit in reference cycles until
        # the collector runs (without this, 24.6 GB stay allocated)
        gc.collect()
        torch.cuda.empty_cache()
        sps = run("sp_stripe", phase_sp_stripe, torch, dev["nvidia_smi"])
        gc.collect()
        torch.cuda.empty_cache()
        grant = run("grant", phase_grant, torch, dev["nvidia_smi"])
        train = run("train", phase_train, torch, dev["nvidia_smi"])
    except PhaseFailed as e:
        print(f"chip_smoke.py: phase {e} failed", file=sys.stderr)
        return 1

    k1m, bwd = k1["main"], k34["main"]
    # K2's two arms, each an entry point a store and a striped one: S > 1
    # (paged_attn.cu) timed at the 2000-token prefill window, S = 1
    # (paged_decode.cu) at decode; launches from the phase that serves
    # that store (server, grant, sp_stripe); no one PyTorch call reads a
    # paged store
    k2_rows = []
    for arm, source, shape, stage in (
            ("attn", "paged_attn.cu", "prefill", PREFILL_STAGE),
            ("decode", "paged_decode.cu", "decode", DECODE_STAGE)):
        for kind, key, line, phase in (
                ("", "", 613, srv), ("_int8", "int8_", 664, grant),
                ("_striped", "striped_", 699, sps["bf16"]),
                ("_int8_striped", "int8_striped_", 722, sps["int8"])):
            case = k2[key + shape]
            counter = f"paged_{arm}{kind}"
            if "striped" in kind:
                counter = (f"launches{'_decode' if arm == 'decode' else ''}"
                           f"{kind}")
            row = {"name": f"paged_{arm}{kind}", "route": "cuda",
                   "source": f"tpushare_torch/ops/csrc/{source}",
                   "replaces": f"tpushare/ops/attention.py:{line}",
                   "launches": phase["launches"][counter],
                   "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                   "kernel_ms": case["ms"], "plain_ms": case["plain_ms"],
                   "bound_ms": case["bound_ms"],
                   "bound_by": case["bound_by"], "library_ms": None,
                   "device_ms": case["device_ms"], "shape": shape,
                   "device_kernels": case["kernels"], "stage": stage}
            if arm == "decode":
                row["n_splits"] = case["n_splits"]
            k2_rows.append(row)
    bwd_kernels = []
    for name, kern, line, outs in (("flash_bwd_dkv", "dkv", 180, "dk dv"),
                                   ("flash_bwd_dq", "dq", 248, "dq")):
        bwd_kernels.append({
            "name": name, "route": "cuda",
            "source": "tpushare_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"tpushare/ops/attention.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": max(bwd["max_abs_err"][o] for o in outs.split()),
            "ms": bwd[f"{kern}_ms"], "kernel_ms": bwd[f"{kern}_ms"],
            # one plain function and one library backward compute K3 and
            # K4 together: their times cover both kernels
            "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd[f"{kern}_bound_ms"],
            "bound_by": bwd[f"{kern}_bound_by"],
            "library_ms": bwd["library_ms"],
            "device_ms": bwd[f"{kern}_device_ms"],
            "library_device_ms": bwd["library_device_ms"],
            "library_kernel": bwd["library_kernel"],
            "tflops": bwd[f"{kern}_tflops"],
            "bound_share": bwd[f"{kern}_bound_share"],
            "long_device_ms": bwd["long"][f"{kern}_device_ms"],
            "long_bound_ms": bwd["long"][f"{kern}_bound_ms"],
            "long_library_device_ms": bwd["long"]["library_device_ms"],
            # the port's whole backward through autograd (dvec, K3, K4)
            # against the library backward, like for like
            "backward_device_ms": bwd["backward_device_ms"],
            "long_backward_device_ms": bwd["long"]["backward_device_ms"],
            "plain_and_library_cover": "flash_bwd_dkv+flash_bwd_dq"})
    emit({"kernels": [
        # ms and library_ms by events around the call (host time in the
        # launch path included); device_ms and library_device_ms the
        # kernels' own time by the profiler; long_* at S = 8192
        {"name": "flash_fwd", "route": "cuda",
         "source": "tpushare_torch/ops/csrc/flash_fwd.cu",
         "replaces": "tpushare/ops/attention.py:109",
         "launches": srv["launches"]["flash_fwd"],
         "max_abs_err": k1m["max_abs_err"], "ms": k1m["ms"],
         "kernel_ms": k1m["ms"],
         "plain_ms": k1m["plain_ms"], "bound_ms": k1m["bound_ms"],
         "bound_by": k1m["bound_by"], "library_ms": k1m["library_ms"],
         "device_ms": k1m["device_ms"],
         "library_device_ms": k1m["library_device_ms"],
         "library_kernel": k1m["library_kernel"],
         "tflops": k1m["tflops"], "bound_share": k1m["bound_share"],
         "long_device_ms": k1m["long"]["device_ms"],
         "long_library_device_ms": k1m["long"]["library_device_ms"],
         "long_bound_ms": k1m["long"]["bound_ms"],
         "long_tflops": k1m["long"]["tflops"]},
        *k2_rows,
        *bwd_kernels,
    ]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
