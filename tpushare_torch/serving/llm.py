"""The port's LLM server: ``python -m tpushare_torch.serving.llm``.

Counterpart of ``tpushare/serving/llm.py`` (``tpushare-llm-server``), with
the same request and response JSON:

* ``POST /generate`` ``{"tokens": [[...], ...], "max_new_tokens": N,
  "temperature": T, "top_k": K, "top_p": P, "seed": S, "eos_id": E}`` ->
  ``{"tokens": [[prompt + generated], ...]}``; each row is its own request
  in the slot pool (row i samples with seed + i), or, with no slots, the
  rows (of one length) are one batch of ``generate_fused`` under a lock,
  truncated after each row's first generated EOS;
* ``POST /score`` ``{"tokens": [[...], ...], "prompt_len": P}`` ->
  ``{"scores": [{"logprobs": [...], "total": t, "scored_tokens": n}]}``;
* ``GET /healthz`` -> ``ok`` (503 with the reason once the service loop
  has failed);
* ``GET /stats`` -> served counts, the batcher's occupancy, the KV pool,
  per-request time to first token, and the K1/K2 launch counters.

Three storages, as in the reference: ``--slots N --page-size P`` (the
defaults, 8 and 16) serves from the paged pool, whose decode and prefill
read it through K2; ``--page-size 0`` from dense slot rows (window-sized
rolling rows for a sliding-window model), ``--slots 0`` one request at a
time through ``generate_fused``, both read by ``cached_attention`` in
plain PyTorch.  ``/score`` runs the no-cache forward through K1.  ``--int8``/``--int4`` quantize the weights
(built one layer slice at a time), ``--kv-dtype int8`` keeps the pool as
int8 stores (K2's int8 entry point); ``--kv-pool-bytes`` sizes the pool
by bytes; ``--sp N`` stripes every sequence's pages over N cards (K2's
striped variant per stripe, merged; ``/score`` then answers 400).
The slot pool streams each prompt in 64-token chunks and, while any
prompt prefills, runs mixed rounds (one prefill forward for the pending
chunks of up to ``--prefill-budget`` tokens, then 8 fused decode steps);
``--sequential-prefill`` runs the reference's sequential interleave
instead.  ``--prefix-cache`` maps a completed request's prompt-head
pages into later requests that share it (paged pool, full causal).
Start-up (:func:`start_server`) follows the device plugin's contract as a
pod does: fail fast on a placement failure, then cap the CUDA allocator
at the granted fraction, then build the model.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from .. import default_device
from ..models import transformer
from ..ops import attention
from ..parallel.mesh import make_mesh
from ..runtime import contract

log = logging.getLogger("tpushare_torch.llm")

MODELS = {
    "llama2-7b": transformer.llama2_7b,
    "llama3-8b": transformer.llama3_8b,
    "mistral-7b": transformer.mistral_7b,
    "flagship-small": transformer.flagship_small,
    "tiny": transformer.tiny,
}


def build_model(name: str, quantize_int8: bool = False, seed: int = 0,
                quantize_int4: bool = False, kv_dtype: str = "bf16",
                attn_kernel: str = "kernel", device=None):
    """(cfg, params) of a named model with random seeded weights.
    ``quantize_int8``/``quantize_int4`` quantize the weight leaves as they
    are drawn, one layer slice at a time (the cfg.dtype tree never exists
    whole: Llama-3-8B's is 16 GB); ``kv_dtype="int8"`` stores the paged
    KV pool quantized; ``attn_kernel`` picks the paged read path."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r} (have {sorted(MODELS)})")
    if quantize_int8 and quantize_int4:
        raise ValueError("pick one of int8 / int4")
    cfg = dataclasses.replace(MODELS[name](), kv_dtype=kv_dtype,
                              attn_kernel=attn_kernel)
    bits = 8 if quantize_int8 else 4 if quantize_int4 else 0
    return cfg, transformer.init_params(cfg, seed=seed, device=device,
                                        quantize_bits=bits)


def kernel_launches() -> dict:
    """Launches so far of K1 and of K2's entry points, by kernel: K2's
    S > 1 arm as ``paged_attn*``, its S = 1 arm as ``paged_decode*``."""
    k2 = attention.paged_decode_attention
    out = {"flash_fwd": attention.flash_attention_lse.launches}
    for kind in attention.K2_KINDS:
        out[f"paged_attn{kind}"] = getattr(k2, f"launches{kind}")
        out[f"paged_decode{kind}"] = getattr(k2, f"launches_decode{kind}")
    return out


class LLMServer:
    def __init__(self, cfg, params, port: int = 8000,
                 addr: str = "127.0.0.1", n_slots: int = 8,
                 page_size: int = 16, n_pages: int = 0,
                 default_max_new: int = 32, device=None,
                 pool_bytes: Optional[int] = None, sp: int = 0,
                 prefix_cache: bool = False, prefill_budget: int = 0,
                 mixed_step: bool = True):
        """``n_slots`` > 0 serves through a ``ContinuousService``: over a
        paged pool with ``page_size`` > 0, over dense slot rows with
        ``page_size`` 0; ``n_slots`` 0 serves each ``/generate`` through
        ``generate_fused``.  ``sp`` > 1 stripes every sequence's KV pages
        over that many shards of a mesh (``make_mesh({"sp": sp})``): over
        the visible cards, or on the CPU over ``device`` repeated.
        ``prefill_budget`` caps the prompt tokens one mixed service round
        coalesces into its prefill block (0 = two prefill chunks);
        ``mixed_step=False`` runs the sequential advance-then-fuse
        rounds instead; ``prefix_cache`` maps a registered prompt head's
        pages into later requests (paged pool, full-causal models)."""
        from .continuous import ContinuousService

        self.device = default_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, "
                             f"the server on {self.device}")
        if sp > 1 and (n_slots <= 0 or page_size <= 0):
            raise ValueError("sp > 1 requires n_slots > 0 and "
                             "page_size > 0 (position striping is a "
                             "paged-pool feature)")
        if (n_pages or pool_bytes) and (n_slots <= 0 or page_size <= 0):
            raise ValueError("n_pages and pool_bytes size the paged pool: "
                             "they need n_slots > 0 and page_size > 0")
        if prefix_cache and (n_slots <= 0 or page_size <= 0):
            raise ValueError("prefix_cache requires n_slots > 0 and "
                             "page_size > 0")
        if (prefill_budget or not mixed_step) and n_slots <= 0:
            raise ValueError("prefill_budget and mixed_step shape the "
                             "slot pool's rounds: they need n_slots > 0")
        mesh = None
        if sp > 1:
            mesh = make_mesh({"sp": sp}, devices=(
                [self.device] * sp if self.device.type == "cpu" else None))
        self.mesh = mesh
        self.cfg = cfg
        self.params = params
        self.default_max_new = default_max_new
        self._score_lock = threading.Lock()   # one /score forward at a time
        self._gen_lock = threading.Lock()     # one generate_fused at a time
        self._count_lock = threading.Lock()
        self.requests_served = 0
        self.sequences_served = 0
        self.tokens_generated = 0
        self._t0 = time.monotonic()
        self._service = None
        if n_slots > 0:
            self._service = ContinuousService(
                params, cfg, n_slots, page_size=page_size,
                n_pages=n_pages or None,
                device=self.device if mesh is None else None,
                pool_bytes=pool_bytes, mesh=mesh,
                prefix_cache=prefix_cache, mixed_step=mixed_step,
                prefill_budget=prefill_budget or None).start()
        self._routes = {("POST", "/generate"): self._generate,
                        ("POST", "/score"): self._score,
                        ("GET", "/healthz"): self._healthz,
                        ("GET", "/stats"): self._stats}
        self._http = ThreadingHTTPServer((addr, port), self._handler_class())
        self._http.daemon_threads = True
        self.port = self._http.server_address[1]
        self._serve_thread = None

    # -- HTTP plumbing -------------------------------------------------
    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, payload):
                if isinstance(payload, str):
                    data, ctype = payload.encode(), "text/plain; charset=utf-8"
                else:
                    data, ctype = json.dumps(payload).encode(), \
                        "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _dispatch(self, method):
                route = server._routes.get((method, self.path.split("?")[0]))
                if route is None:
                    return self._send(404, {"Error": "not found"})
                body = None
                if method == "POST":
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(n) or b"{}")
                    except (ValueError, json.JSONDecodeError) as e:
                        return self._send(400, {"Error": f"bad json: {e}"})
                    if not isinstance(body, dict):
                        return self._send(400, {"Error": "body must be a "
                                                         "JSON object"})
                try:
                    code, payload = route(body)
                except Exception as e:        # the server keeps answering
                    log.exception("%s %s failed", method, self.path)
                    code, payload = 500, {"Error": repr(e)}
                self._send(code, payload)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

        return Handler

    def start(self) -> "LLMServer":
        self._serve_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True,
            name="tpushare-torch-http")
        self._serve_thread.start()
        return self

    def serve_forever(self) -> None:
        self._http.serve_forever()

    def stop(self) -> None:
        if self._serve_thread is not None:
            self._http.shutdown()
            self._serve_thread.join(timeout=10)
        self._http.server_close()
        if self._service is not None:
            self._service.stop()

    # -- routes --------------------------------------------------------
    def _healthz(self, _body):
        failure = None if self._service is None else self._service.failure
        if failure is not None:
            return 503, {"state": "failed", "reason": repr(failure)}
        return 200, "ok\n"

    def _parse_gen_fields(self, body):
        try:
            f = {"max_new": int(body.get("max_new_tokens",
                                         self.default_max_new)),
                 "temperature": float(body.get("temperature", 0.0)),
                 "seed": int(body.get("seed", 0)),
                 "top_k": int(body.get("top_k", 0)),
                 "top_p": float(body.get("top_p", 1.0))}
            eos = body.get("eos_id")
            f["eos_id"] = int(eos) if eos is not None else None
        except (TypeError, ValueError) as e:
            return None, (400, {"Error": f"malformed field: {e}"})
        if f["eos_id"] is not None and not 0 <= f["eos_id"] < self.cfg.vocab:
            return None, (400, {"Error": f"eos_id out of range [0, "
                                         f"{self.cfg.vocab})"})
        return f, None

    def _rows(self, body, min_len: int):
        tokens = body.get("tokens")
        if (not tokens or not isinstance(tokens, list)
                or not all(isinstance(r, list) and len(r) >= min_len
                           for r in tokens)):
            return None, (400, {"Error": "body must contain tokens: "
                                         "[[int, ...], ...]"})
        try:
            rows = [[int(t) for t in r] for r in tokens]
        except (TypeError, ValueError) as e:
            return None, (400, {"Error": f"malformed field: {e}"})
        if any(t < 0 or t >= self.cfg.vocab for r in rows for t in r):
            return None, (400, {"Error": f"token id out of range [0, "
                                         f"{self.cfg.vocab})"})
        return rows, None

    def _generate(self, body):
        rows, err = self._rows(body, 1)
        if err is not None:
            return err
        f, err = self._parse_gen_fields(body)
        if err is not None:
            return err
        if self._service is None:
            return self._generate_fused(rows, f)
        try:
            # every row is checked before any is queued: a refused row
            # leaves no orphaned work behind
            for row in rows:
                self._service.validate(row, f["max_new"], f["top_k"],
                                       f["top_p"])
            sinks = [self._service.submit(
                row, f["max_new"], temperature=f["temperature"],
                seed=f["seed"] + i, eos_id=f["eos_id"], top_k=f["top_k"],
                top_p=f["top_p"]) for i, row in enumerate(rows)]
        except ValueError as e:
            return 400, {"Error": str(e)}
        try:
            outs = [s.get(timeout=600) for s in sinks]
        except queue.Empty:
            return 504, {"Error": "generation timed out"}
        if any(o is None for o in outs):
            return 503, {"Error": "server shutting down"}
        for o in outs:
            if isinstance(o, BaseException):
                return 500, {"Error": f"generation failed: {o!r}"}
        with self._count_lock:
            self.requests_served += 1
            self.sequences_served += len(rows)
            self.tokens_generated += sum(len(o) - len(r)
                                         for o, r in zip(outs, rows))
        return 200, {"tokens": outs}

    def _generate_fused(self, rows, f):
        """The serialized arm (``n_slots`` 0): the rows as one batch of
        ``generate_fused`` (greedy or temperature sampling from a
        generator seeded by ``seed``; no top-k/top-p, as in the
        reference), each row truncated after its first generated EOS, so
        both arms answer alike."""
        from .generate import generate_fused

        if len({len(r) for r in rows}) != 1:
            return 400, {"Error": "token rows must share one length (pad "
                                  "client-side, or run with --slots)"}
        if len(rows[0]) + f["max_new"] > self.cfg.max_seq:
            return 400, {"Error": f"prompt+max_new_tokens exceeds "
                                  f"max_seq={self.cfg.max_seq}"}
        if f["max_new"] < 1:
            return 400, {"Error": "max_new_tokens must be >= 1"}
        with self._gen_lock:
            gen = torch.Generator(device=self.device).manual_seed(f["seed"])
            out = generate_fused(
                self.params, self.cfg,
                torch.tensor(rows, dtype=torch.long, device=self.device),
                max_new_tokens=f["max_new"], temperature=f["temperature"],
                generator=gen, eos_id=f["eos_id"]).tolist()
        outs = []
        for row, src in zip(out, rows):
            new = row[len(src):]
            if f["eos_id"] is not None and f["eos_id"] in new:
                row = row[:len(src) + new.index(f["eos_id"]) + 1]
            outs.append(row)
        with self._count_lock:
            self.requests_served += 1
            self.sequences_served += len(rows)
            self.tokens_generated += sum(len(o) - len(r)
                                         for o, r in zip(outs, rows))
        return 200, {"tokens": outs}

    def _score(self, body):
        from .score import score_tokens

        rows, err = self._rows(body, 2)
        if err is not None:
            return err
        if len({len(r) for r in rows}) != 1:
            return 400, {"Error": "token rows must share one length"}
        try:
            prompt_len = int(body.get("prompt_len", 1))
        except (TypeError, ValueError) as e:
            return 400, {"Error": f"malformed field: {e}"}
        if len(rows[0]) > self.cfg.max_seq:
            return 400, {"Error": f"sequence exceeds max_seq="
                                  f"{self.cfg.max_seq}"}
        if not 1 <= prompt_len < len(rows[0]):
            return 400, {"Error": "prompt_len must be in [1, len-1]"}
        if self.mesh is not None:
            return 400, {"Error": "/score is not mesh-aware yet; run "
                                  "without --sp to score"}
        with self._score_lock:
            lp = score_tokens(self.params, self.cfg,
                              torch.tensor(rows, device=self.device))
            rows_lp = [[round(float(x), 4) for x in r] for r in lp.tolist()]
        with self._count_lock:
            self.requests_served += 1
            self.sequences_served += len(rows)
        out = []
        for row_lp in rows_lp:
            scored = row_lp[prompt_len - 1:]
            out.append({"logprobs": scored, "total": round(sum(scored), 4),
                        "scored_tokens": len(scored)})
        return 200, {"scores": out}

    def _stats(self, _body):
        dt = time.monotonic() - self._t0
        with self._count_lock:
            stats = {"requests_served": self.requests_served,
                     "sequences_served": self.sequences_served,
                     "tokens_generated": self.tokens_generated}
        timings = ([] if self._service is None
                   else list(self._service.timings))
        ttfts = [t["ttft_s"] for t in timings]
        stats.update({
            "uptime_s": round(dt, 1),
            "tokens_per_s": (round(stats["tokens_generated"] / dt, 2)
                             if dt else 0),
            "device": str(self.device),
            "ttft_s": {"n": len(ttfts),
                       "mean": sum(ttfts) / len(ttfts) if ttfts else None,
                       "max": max(ttfts) if ttfts else None},
            "kernel_launches": kernel_launches(),
        })
        if self._service is not None:
            stats["batcher"] = self._service.snapshot()
            stats["kv_storage"] = self._service.storage_info()
        return 200, stats


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m tpushare_torch.serving.llm",
        description="LLM generation server (PyTorch/CUDA port)")
    ap.add_argument("--model", default="flagship-small",
                    choices=sorted(MODELS))
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    weights = ap.add_mutually_exclusive_group()
    weights.add_argument("--int8", action="store_true",
                       help="int8 per-channel weights (built one layer "
                            "slice at a time)")
    weights.add_argument("--int4", action="store_true",
                       help="grouped int4 weights")
    ap.add_argument("--kv-dtype", choices=transformer.KV_DTYPES,
                    default="bf16",
                    help="paged KV storage: bf16, or int8 stores with "
                         "per-token scales (about 2x the pages per byte)")
    ap.add_argument("--slots", type=int, default=8,
                    help="continuous-batching slot count (0 = one "
                         "request at a time through generate_fused)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV-cache page size in tokens (0 = dense slot "
                         "rows; rolling rows for a sliding-window model)")
    pool = ap.add_mutually_exclusive_group()
    pool.add_argument("--kv-pages", type=int, default=0,
                      help="paged-KV pool size in pages (0 = every slot "
                           "can hold max_seq tokens, plus the trash page)")
    pool.add_argument("--kv-pool-bytes", type=int, default=0,
                      help="paged-KV pool size in bytes (the pages this "
                           "budget buys at --kv-dtype)")
    ap.add_argument("--attn-kernel", choices=transformer.ATTN_KERNELS,
                    default="kernel",
                    help="paged read path: 'kernel' (the CUDA kernel) or "
                         "'gather' (dense view + plain attention)")
    ap.add_argument("--sp", type=int, default=0,
                    help="position-striping degree: stripe every "
                         "sequence's KV pages round-robin over this many "
                         "cards (one stripe a visible card), multiplying "
                         "per-sequence max context and KV memory by it; "
                         "/score is refused under it")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse completed requests' prompt-prefix KV "
                         "pages for same-prefix admissions (requires "
                         "--page-size; full-causal models)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="prompt tokens one mixed service round may "
                         "coalesce into its one prefill forward (0 = "
                         "two prefill chunks; requires --slots)")
    ap.add_argument("--sequential-prefill", action="store_true",
                    help="disable the mixed prefill+decode round: one "
                         "prefill forward per prefilling slot, then the "
                         "fused decode steps (the reference interleave; "
                         "requires --slots)")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--addr", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch paths)")
    args = ap.parse_args(argv)
    if args.prefill_budget and not args.slots:
        ap.error("--prefill-budget requires --slots")
    if args.sequential_prefill and not args.slots:
        ap.error("--sequential-prefill requires --slots")
    if args.prefix_cache and not (args.slots and args.page_size):
        ap.error("--prefix-cache requires --slots and --page-size")
    return args


def start_server(args: argparse.Namespace, env=None) -> LLMServer:
    """What a pod runs before it serves: the device plugin's env contract
    (``env``, default ``os.environ``) first — a placement failure raises
    :class:`~tpushare_torch.runtime.contract.AllocationFailed` before
    anything is built — then the CUDA allocator capped at the granted
    fraction, then the model and the server (bound, not yet serving)."""
    view = contract.enforce(env)
    device = default_device(args.device)
    contract.apply_memory_budget(env, device)
    if view.allocated:
        log.info("allocation: chip %s, %.1f%% of the card's memory",
                 view.chip_index, (view.hbm_fraction or 1.0) * 100)
    else:
        log.info("running unallocated (dev mode)")
    cfg, params = build_model(args.model, quantize_int8=args.int8,
                              seed=args.seed, quantize_int4=args.int4,
                              kv_dtype=args.kv_dtype,
                              attn_kernel=args.attn_kernel, device=device)
    srv = LLMServer(cfg, params, port=args.port, addr=args.addr,
                    n_slots=args.slots, page_size=args.page_size,
                    n_pages=args.kv_pages, device=device,
                    pool_bytes=args.kv_pool_bytes or None, sp=args.sp,
                    prefix_cache=args.prefix_cache,
                    prefill_budget=args.prefill_budget,
                    mixed_step=not args.sequential_prefill)
    log.info("llm server: model=%s weights=%s kv_dtype=%s attn_kernel=%s "
             "device=%s on %s:%d", args.model,
             "int8" if args.int8 else "int4" if args.int4 else "bf16",
             cfg.kv_dtype, cfg.attn_kernel, srv.device, args.addr, srv.port)
    return srv


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    srv = start_server(args)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
