"""The port's LLM server: ``python -m tpushare_torch.serving.llm``.

Counterpart of ``tpushare/serving/llm.py`` (``tpushare-llm-server``), with
the same request and response JSON:

* ``POST /generate`` ``{"tokens": [[...], ...], "max_new_tokens": N,
  "temperature": T, "top_k": K, "top_p": P, "seed": S, "eos_id": E,
  "adapter": A}`` -> ``{"tokens": [[prompt + generated], ...]}``; each row
  is its own request in the slot pool (row i samples with seed + i), or,
  with no slots, the rows (of one length) are one batch of
  ``generate_fused`` under a lock, truncated after each row's first
  generated EOS.  ``{"text": "..."}`` in place of ``tokens`` (a model of
  at least ``tokenizer.VOCAB_FLOOR`` ids) is one row of the byte
  tokenizer's ids, and the answer adds ``"text"``, each row decoded;
* ``POST /score`` ``{"tokens": [[...], ...], "prompt_len": P}`` ->
  ``{"scores": [{"logprobs": [...], "total": t, "scored_tokens": n}]}``;
* ``POST /generate_stream`` (one prompt row, the same fields) -> NDJSON
  lines ``{"delta": [new tokens]}`` as rounds produce them, then ``{"done":
  [row]}``; a client that drops the connection cancels its request;
* ``POST /generate`` with ``"phase": "prefill"`` (one row; paged pool) ->
  ``{"migration": <base64 blob>}``, the session exported the moment its
  first token is sampled (or ``{"tokens": ...}`` if it finished there),
  for a decode replica's ``/migrate_in``;
* ``POST /migrate_in`` ``{"blob": <base64>}`` -> the session decoded to
  completion here, ``{"tokens": [row], "served_s": s}``; refused with 409
  and the counted reason (``pool_full``, ``config_mismatch``,
  ``bad_blob``, ``unsupported_storage``), or 400 ``bad_blob`` for a body
  that does not decode;
* ``POST /drain`` -> stops admitting (503 ``draining`` on ``/generate``,
  ``/generate_stream``, ``/score``, ``/migrate_in``) and reports
  ``draining``/``inflight``/``drained``; ``{"undrain": true}`` re-opens;
  ``{"migrate_to": "host:port"}`` also moves the decoding sessions to
  that peer's ``/migrate_in`` one blob at a time and hands each finished
  stream back to its client here (a refused one resumes here);
* ``GET /healthz`` -> the health monitor's answer: ``ok``, or the state
  and reason; 503 exactly when WEDGED (a dispatch stalled past its
  deadline) or once the service loop has failed; while draining the body
  carries the drain fields;
* ``GET /stats`` -> served counts, the batcher's occupancy, the KV pool,
  per-request time to first token, the K1/K2 launch counters, and the
  health and tenant-policy snapshots;
* ``GET /metrics`` -> the telemetry registry in the Prometheus text
  format (qps and device utilization refreshed first): what ``kubectl
  inspect tpushare --metrics`` scrapes;
* ``GET /debug/trace`` and ``GET /debug/events`` (``?since=<seq>`` tails
  them) -> the span ring as Chrome trace JSON, the flight recorder as
  JSONL.

Tenant policy (``--policy auto``, the default): under an allocation env
that carries ``TPUSHARE_STATUS_PORT``, :func:`start_server` reports the
tenant's usage to the node daemon every ``TPUSHARE_USAGE_REPORT_S``
seconds (``runtime.contract.report_usage``) and applies each answer's
verdict: ``pace:<rate>`` paces the dispatches at the dispatch guard,
``refuse`` answers ``/generate`` and ``/score`` with 429 + ``Retry-After``
until an ``ok`` or ``pace`` verdict; ``--pace-rate`` self-paces without
any daemon; ``--policy off`` ignores verdicts.

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
``--spec-k K`` speculates by prompt lookup on any slot storage: while a
greedy request decodes, a round is 4 verify forwards of
``[slots, 1+K]`` blocks (K2's S > 1 arm on the paged pool), greedy-exact;
``/stats`` then carries a ``speculation`` block under ``batcher``.
``--spill-bytes N`` (paged pool) parks the longest-resident session's KV
in host RAM, up to N bytes, when admission finds the pool full, and
faults it back in when the queue is empty.  ``--adapter-slots N`` (with
``--slots``) serves multi-adapter LoRA from a pool of N named adapters of
rank ``--adapter-rank``: a request's ``"adapter": name`` loads it on first
use (synthetic weights drawn from the name), the rows of a round may mix
adapters, and an admission naming an adapter that is not resident while
every pool row is pinned answers 503 + ``Retry-After``; ``/stats``'
``kv_storage`` carries the pool's bytes beside a merged model's.  Session blobs are the JAX
package's wire format (``serving/migrate.py``), so torch and JAX
replicas of one model and pool layout hand sessions to each other.
Start-up (:func:`start_server`) follows the device plugin's contract as a
pod does: fail fast on a placement failure, then cap the CUDA allocator
at the granted fraction, then build the model.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import queue
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl

import torch

from .. import default_device, telemetry
from ..models import transformer
from ..ops import attention
from ..parallel.mesh import make_mesh
from ..runtime import contract
from ..telemetry import health
from ..telemetry.events import debug_events_route
from ..telemetry.trace import debug_trace_route
from ..utils.httpserver import RawBody, StreamingBody
from . import metrics, migrate
from .policy import PolicyClient
from .tokenizer import VOCAB_FLOOR, ByteTokenizer

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
                attn_kernel: str = "kernel", device=None,
                n_experts: int = 0, moe_top_k: int = 1,
                moe_every: int = 1):
    """(cfg, params) of a named model with random seeded weights.
    ``quantize_int8``/``quantize_int4`` quantize the weight leaves as they
    are drawn, one layer slice at a time (the cfg.dtype tree never exists
    whole: Llama-3-8B's is 16 GB); ``kv_dtype="int8"`` stores the paged
    KV pool quantized; ``attn_kernel`` picks the paged read path.
    ``n_experts`` > 0 serves the model's mixture-of-experts variant: every
    ``moe_every``-th layer's FFN a routed pool of that many experts, each
    token taking ``moe_top_k`` (the expert leaves stay unquantized)."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r} (have {sorted(MODELS)})")
    if quantize_int8 and quantize_int4:
        raise ValueError("pick one of int8 / int4")
    cfg = dataclasses.replace(MODELS[name](), kv_dtype=kv_dtype,
                              attn_kernel=attn_kernel)
    if n_experts:
        cfg = dataclasses.replace(cfg, n_experts=n_experts,
                                  moe_top_k=moe_top_k, moe_every=moe_every)
    bits = 8 if quantize_int8 else 4 if quantize_int4 else 0
    return cfg, transformer.init_params(cfg, seed=seed, device=device,
                                        quantize_bits=bits)


def kernel_launches() -> dict:
    """Launches so far of K1 and of K2's entry points, by kernel: K2's
    S > 1 arm as ``paged_attn*`` (prefill windows and speculation's
    verify blocks), its S = 1 arm as ``paged_decode*``."""
    k2 = attention.paged_decode_attention
    out = {"flash_fwd": attention.flash_attention_lse.launches}
    for kind in attention.K2_KINDS:
        out[f"paged_attn{kind}"] = getattr(k2, f"launches{kind}")
        out[f"paged_decode{kind}"] = getattr(k2, f"launches_decode{kind}")
    return out


class _CountedChunks:
    """A stream body whose ``on_end`` fires EXACTLY once: consumed to its
    end, closed mid-iteration, or closed before iteration starts (a
    generator closed unstarted never runs its own ``finally``, which
    would pin the drain's in-flight count)."""

    def __init__(self, inner, on_end):
        self._inner = inner
        self._on_end = on_end
        self._done = False

    def _finish(self):
        if not self._done:
            self._done = True
            self._on_end()

    def __iter__(self):
        try:
            for chunk in self._inner:
                yield chunk
        finally:
            self._finish()

    def close(self):
        close = getattr(self._inner, "close", None)
        try:
            if close is not None:
                close()
        finally:
            self._finish()


class LLMServer:
    def __init__(self, cfg, params, port: int = 8000,
                 addr: str = "127.0.0.1", n_slots: int = 8,
                 page_size: int = 16, n_pages: int = 0,
                 default_max_new: int = 32, device=None,
                 pool_bytes: Optional[int] = None, sp: int = 0, tp: int = 0,
                 prefix_cache: bool = False, prefill_budget: int = 0,
                 mixed_step: bool = True, spec_k: int = 0,
                 policy_client=None, spill_bytes: int = 0,
                 adapter_slots: int = 0, adapter_rank: int = 8):
        """``n_slots`` > 0 serves through a ``ContinuousService``: over a
        paged pool with ``page_size`` > 0, over dense slot rows with
        ``page_size`` 0; ``n_slots`` 0 serves each ``/generate`` through
        ``generate_fused``.  ``sp`` > 1 stripes every sequence's KV pages
        over that many shards of a mesh, and ``tp`` > 1 serves
        tensor-parallel over that many (the Megatron split of the weights,
        the KV storage and the adapter pool on heads; any slot storage):
        the mesh is ``make_mesh({"tp": tp, "sp": sp})`` over the visible
        cards, or on the CPU over ``device`` repeated.
        ``prefill_budget`` caps the prompt tokens one mixed service round
        coalesces into its prefill block (0 = two prefill chunks);
        ``mixed_step=False`` runs the sequential advance-then-fuse
        rounds instead; ``prefix_cache`` maps a registered prompt head's
        pages into later requests (paged pool, full-causal models);
        ``spec_k`` > 0 speculates by prompt lookup at that depth while a
        greedy request decodes (any slot storage).  ``policy_client``
        (``serving.policy.PolicyClient``, or None) gates admission with
        429 + ``Retry-After`` while its refusal window is open, and its
        pacer rides every dispatch guard while the server runs.
        ``spill_bytes`` > 0 arms the host-RAM spill tier of that many
        bytes (paged pool).  ``adapter_slots`` > 0 serves multi-adapter
        LoRA from a pool of that many named adapters of rank
        ``adapter_rank`` (any slot storage)."""
        from .continuous import ContinuousService

        self.device = default_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, "
                             f"the server on {self.device}")
        if sp > 1 and (n_slots <= 0 or page_size <= 0):
            raise ValueError("sp > 1 requires n_slots > 0 and "
                             "page_size > 0 (position striping is a "
                             "paged-pool feature)")
        if tp > 1 and n_slots <= 0:
            # only the slot pool is mesh-aware; serving unsplit would
            # defeat the point of asking for tp
            raise ValueError("tp > 1 requires n_slots > 0 "
                             "(tensor-parallel serving rides the "
                             "continuous batcher)")
        if (n_pages or pool_bytes) and (n_slots <= 0 or page_size <= 0):
            raise ValueError("n_pages and pool_bytes size the paged pool: "
                             "they need n_slots > 0 and page_size > 0")
        if prefix_cache and (n_slots <= 0 or page_size <= 0):
            raise ValueError("prefix_cache requires n_slots > 0 and "
                             "page_size > 0")
        if (prefill_budget or not mixed_step) and n_slots <= 0:
            raise ValueError("prefill_budget and mixed_step shape the "
                             "slot pool's rounds: they need n_slots > 0")
        if spec_k and n_slots <= 0:
            raise ValueError("spec_k speculates in the slot pool's rounds: "
                             "it needs n_slots > 0")
        if spill_bytes and (n_slots <= 0 or page_size <= 0):
            raise ValueError("spill_bytes spills paged sessions: it needs "
                             "n_slots > 0 and page_size > 0")
        if adapter_slots > 0 and n_slots <= 0:
            raise ValueError("adapter_slots > 0 requires n_slots > 0 "
                             "(multi-adapter serving rides the slot pool)")
        self._adapter_slots = int(adapter_slots)
        mesh = None
        axes = {name: n for name, n in (("tp", tp), ("sp", sp)) if n > 1}
        if axes:
            n = max(tp, 1) * max(sp, 1)
            mesh = make_mesh(axes, devices=(
                [self.device] * n if self.device.type == "cpu" else None))
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
        # the drain: admission stops while set; requests in the handlers
        # are counted so that drained means nothing is left
        self._draining = threading.Event()
        self._handlers_lock = threading.Lock()
        self._in_handlers = 0
        self._policy_client = policy_client
        pacer = policy_client.pacer if policy_client is not None else None
        self._reports_halt = threading.Event()
        self._report_thread = None
        self._service = None
        if n_slots > 0:
            # the service installs its pacer for its lifetime
            self._service = ContinuousService(
                params, cfg, n_slots, page_size=page_size,
                n_pages=n_pages or None,
                device=self.device if mesh is None else None,
                pool_bytes=pool_bytes, mesh=mesh,
                prefix_cache=prefix_cache, mixed_step=mixed_step,
                prefill_budget=prefill_budget or None,
                spec_k=spec_k, policy=pacer,
                spill_bytes=spill_bytes or None,
                adapter_slots=adapter_slots,
                adapter_rank=adapter_rank).start()
        elif pacer is not None:
            # no service lifecycle to ride: arm the guards' pacer here,
            # stop() disarms it
            health.MONITOR.install_policy(pacer)
        self._routes = {("POST", "/generate"): self._generate,
                        ("POST", "/generate_stream"): self._generate_stream,
                        ("POST", "/score"): self._score,
                        ("POST", "/drain"): self._drain,
                        ("POST", "/migrate_in"): self._migrate_in,
                        ("GET", "/healthz"): self._healthz,
                        ("GET", "/stats"): self._stats,
                        ("GET", "/metrics"): self._metrics,
                        ("GET", "/debug/trace"): debug_trace_route,
                        ("GET", "/debug/events"): debug_events_route}
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

            def _send(self, code, payload, headers=None):
                if isinstance(payload, StreamingBody):
                    return self._send_stream(code, payload, headers)
                if isinstance(payload, RawBody):
                    data, ctype = payload.data, payload.content_type
                elif isinstance(payload, str):
                    data, ctype = payload.encode(), "text/plain; charset=utf-8"
                else:
                    data, ctype = json.dumps(payload).encode(), \
                        "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _send_stream(self, code, payload, headers):
                """Each chunk written and flushed as it comes, the body
                ended by the connection's close; the chunks are closed on
                every path (a disconnect cancels the request at once)."""
                try:
                    # the headers inside the guard: a client gone before
                    # them must still reach the close
                    self.send_response(code)
                    self.send_header("Content-Type", payload.content_type)
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    for chunk in payload.chunks:
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass                # the client went away mid-stream
                finally:
                    close = getattr(payload.chunks, "close", None)
                    if close is not None:
                        close()
                self.close_connection = True

            def _dispatch(self, method):
                path, _, qs = self.path.partition("?")
                route = server._routes.get((method, path))
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
                    if getattr(route, "wants_query", False):
                        result = route(body, dict(parse_qsl(qs)))
                    else:
                        result = route(body)
                except Exception as e:        # the server keeps answering
                    log.exception("%s %s failed", method, self.path)
                    result = 500, {"Error": repr(e)}
                # (code, payload) or (code, payload, headers)
                self._send(*result)

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
        self._reports_halt.set()
        if self._report_thread is not None:
            self._report_thread.join(timeout=10)
        if self._serve_thread is not None:
            self._http.shutdown()
            self._serve_thread.join(timeout=10)
        self._http.server_close()
        if self._service is not None:
            self._service.stop()
        elif self._policy_client is not None:
            health.MONITOR.uninstall_policy(self._policy_client.pacer)

    def start_usage_reports(self, env=None, interval_s: float = 30.0):
        """Report this tenant's usage to the node daemon every
        ``interval_s`` seconds (``contract.report_usage``, the address
        from ``env``) on a thread that :meth:`stop` ends, and feed each
        answer to the policy client.  A report never raises: a daemon
        that is down costs nothing but the report."""
        def loop():
            while not self._reports_halt.wait(interval_s):
                resp = contract.report_usage(device=self.device, env=env)
                if self._policy_client is not None and isinstance(resp,
                                                                  dict):
                    self._policy_client.apply(resp)

        self._report_thread = threading.Thread(
            target=loop, daemon=True, name="tpushare-torch-usage-report")
        self._report_thread.start()
        return self

    # -- routes --------------------------------------------------------
    def _refused(self):
        """The tenant policy's admission gate: while the policy client's
        refusal window is open (a daemon ``refuse`` verdict), 429 with a
        bounded-backoff ``Retry-After``, counted; else None.  A refused
        request never reaches the card and may be sent again."""
        if self._policy_client is None:
            return None
        retry_s = self._policy_client.refusal_retry_after()
        if retry_s <= 0:
            return None
        metrics.POLICY_REFUSALS.inc()
        return (429, {"Error": "admission refused by tenant policy "
                               "(device-time share over entitlement); "
                               "retry after the indicated backoff"},
                {"Retry-After": str(max(1, int(retry_s + 0.5)))})

    # -- the drain ---------------------------------------------------
    def _begin_request(self):
        """The admission gate of the request routes: 503 while draining
        (a router re-dispatches it elsewhere), else the tenant policy's
        429, else the request counts as in flight.  Returns the refusal
        or None."""
        with self._handlers_lock:
            # checked and counted under the lock /drain sets its flag
            # under: a request admitted between the two would be missing
            # from a drained /healthz
            if self._draining.is_set():
                return 503, {"Error": "draining: not admitting new "
                                      "requests"}
            refused = self._refused()
            if refused is not None:
                return refused
            self._in_handlers += 1
        return None

    def _end_request(self):
        with self._handlers_lock:
            self._in_handlers = max(0, self._in_handlers - 1)

    def _counted(self, route, body):
        refused = self._begin_request()
        if refused is not None:
            return refused
        try:
            return route(body)
        finally:
            self._end_request()

    def _drain_snapshot(self) -> dict:
        """What /drain and a draining /healthz report: the requests in the
        handlers plus what the slot pool still holds (a spilled session
        included); drained once every count is zero."""
        with self._handlers_lock:
            inflight = self._in_handlers
        pending = inflight
        if self._service is not None:
            s = self._service.snapshot()
            pending += (s["active"] + s["prefilling"] + s["queued"]
                        + s.get("spilled", 0))
        return {"draining": self._draining.is_set(), "inflight": inflight,
                "drained": self._draining.is_set() and pending == 0}

    def _drain(self, body=None):
        """``{}`` drains; ``{"undrain": true}`` re-admits (a router undoes
        its own drains).  ``{"migrate_to": "host:port"}`` also moves the
        decoding sessions to that peer instead of waiting them out
        (:meth:`_migrate_sessions`)."""
        migrate_to = None
        with self._handlers_lock:
            if isinstance(body, dict) and body.get("undrain"):
                if self._draining.is_set():
                    log.info("undrained: admission re-opened")
                self._draining.clear()
            else:
                if not self._draining.is_set():
                    log.info("draining: admission stopped; in-flight "
                             "requests run to completion")
                self._draining.set()
                if isinstance(body, dict):
                    migrate_to = body.get("migrate_to") or None
        snap = self._drain_snapshot()
        if migrate_to is not None:
            if self._service is None or not self._service.can_migrate():
                metrics.MIGRATION_REFUSED.inc(reason="unsupported_storage")
                snap["migrating_to"] = None
                snap["Error"] = ("migrate_to needs paged slot-pool "
                                 "serving (--slots + --page-size)")
            else:
                threading.Thread(target=self._migrate_sessions,
                                 args=(str(migrate_to),), daemon=True,
                                 name="tpushare-torch-drain").start()
                snap["migrating_to"] = migrate_to
        return 200, snap

    def _migrate_sessions(self, target: str) -> None:
        """Move every decoding session to ``target`` (host:port), one blob
        at a time, handing each finished stream back to its client here.
        A failed hand-off resumes the session here and stops: the rest
        drain the plain way."""
        if "://" not in target:
            target = f"http://{target}"
        moved = 0
        while True:
            got = self._service.migrate_out()
            if got is None:
                break
            rid, blob = got
            try:
                req = urllib.request.Request(
                    f"{target}/migrate_in",
                    data=json.dumps(
                        {"blob": migrate.encode_blob(blob)}).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=600) as resp:
                    tokens = json.loads(resp.read())["tokens"][0]
            except Exception as e:
                log.warning("session %d hand-off to %s failed (%s); "
                            "resuming it here", rid, target, e)
                self._service.reimport(rid, blob)
                break
            self._service.deliver_migrated(rid, tokens)
            moved += 1
        if moved:
            log.info("drain moved %d session(s) to %s", moved, target)

    def _migrate_in(self, body):
        return self._counted(self._migrate_in_impl, body)

    def _migrate_in_impl(self, body):
        """Import a session blob and serve it to completion: answers as
        /generate does (the whole row, what the sender generated
        included), with ``served_s``, this handler's import and decode
        wall (the router splits its hand-off hop by it).  A refusal is 409
        with the counted reason."""
        t_in = time.perf_counter()
        if self._service is None or not self._service.can_migrate():
            metrics.MIGRATION_REFUSED.inc(reason="unsupported_storage")
            return 409, {"Error": "migration refused: unsupported_storage "
                                  "(this replica runs without --slots/"
                                  "--page-size)"}
        data = body.get("blob") if isinstance(body, dict) else None
        if not isinstance(data, str) or not data:
            return 400, {"Error": "body must carry blob: <base64>"}
        try:
            blob = migrate.decode_blob(data)
            arrived = len(migrate.blob_meta(blob)["slot"]["output"])
        except (migrate.BlobError, KeyError, TypeError):
            metrics.MIGRATION_REFUSED.inc(reason="bad_blob")
            return 400, {"Error": "migration refused: bad_blob"}
        sink = self._service.import_session(blob)
        try:
            out = sink.get(timeout=600)
        except queue.Empty:
            return 504, {"Error": "migrated session timed out"}
        if out is None:
            return 503, {"Error": "server shutting down"}
        if isinstance(out, BaseException):
            return 500, {"Error": f"generation failed: {out!r}"}
        if isinstance(out, tuple):
            return 409, {"Error": f"migration refused: {out[1]}"}
        with self._count_lock:
            self.requests_served += 1
            self.sequences_served += 1
            # only what THIS replica decoded; the sender counts its own
            self.tokens_generated += max(0, len(out) - arrived)
        return 200, {"tokens": [out], "served_s": time.perf_counter() - t_in}

    def _healthz(self, _body):
        failure = None if self._service is None else self._service.failure
        if failure is not None:
            return 503, {"state": "failed", "reason": repr(failure)}
        code, body = health.MONITOR.healthz()
        if not self._draining.is_set():
            return code, body
        body = {"state": "ok"} if isinstance(body, str) else dict(body)
        body.update(self._drain_snapshot())
        return code, body

    def _refresh_qps(self) -> float:
        """Mirror the served rate into the registry at read time, so a
        scraper of /metrics alone sees a live value."""
        dt = time.monotonic() - self._t0
        if dt:
            metrics.QPS.set(round(self.requests_served / dt, 3))
        return dt

    def _metrics(self, _body):
        self._refresh_qps()
        # the goodput gauge reflects the device-time series as of THIS
        # exposition
        health.refresh_device_utilization()
        return 200, RawBody(telemetry.REGISTRY.render(),
                            telemetry.PROM_CONTENT_TYPE)

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
        adapter = body.get("adapter")
        if adapter is not None and (not isinstance(adapter, str)
                                    or not adapter):
            return None, (400, {"Error": "adapter must be a non-empty "
                                         "string"})
        if adapter and not self._adapter_slots:
            return None, (400, {"Error": "adapter serving needs the "
                                         "adapter pool; run with --slots "
                                         "and --adapter-slots"})
        f["adapter"] = adapter
        return f, None

    def _adapter_busy(self, f):
        """The adapter pool's admission gate: 503 + ``Retry-After`` while
        the request's adapter is not resident and every pool row is
        pinned by a request in flight (pins release as requests finish),
        else None."""
        if not f["adapter"] or not self._service.adapter_pressure(
                f["adapter"]):
            return None
        return (503, {"Error": "adapter pool at capacity (every resident "
                               "adapter pinned by an in-flight request); "
                               "retry after the indicated backoff"},
                {"Retry-After": "2"})

    def _text_rows(self, body):
        """A ``{"text": ...}`` body as one row of the byte tokenizer's ids:
        (rows, None), or (None, the 400) when tokens come too, the vocab is
        under ``VOCAB_FLOOR`` or the text is empty or not a string."""
        if body.get("tokens") is not None:
            return None, (400, {"Error": "send either text or tokens, not "
                                         "both"})
        if self.cfg.vocab < VOCAB_FLOOR:
            return None, (400, {"Error": "model vocab too small for the "
                                         "byte tokenizer; send tokens"})
        text = body.get("text")
        if not isinstance(text, str) or not text:
            return None, (400, {"Error": "text must be a non-empty string"})
        return [ByteTokenizer().encode(text)], None

    @staticmethod
    def _result(rows, text_mode: bool) -> dict:
        """The answer of /generate: the token rows, and in text mode each
        row decoded beside them."""
        payload = {"tokens": rows}
        if text_mode:
            tok = ByteTokenizer()
            payload["text"] = [tok.decode(row) for row in rows]
        return payload

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
        return self._counted(self._generate_impl, body)

    def _generate_impl(self, body):
        text_mode = "text" in body
        rows, err = (self._text_rows(body) if text_mode
                     else self._rows(body, 1))
        if err is not None:
            return err
        f, err = self._parse_gen_fields(body)
        if err is not None:
            return err
        phase = body.get("phase", "full")
        if phase not in ("full", "prefill"):
            return 400, {"Error": "phase must be 'full' or 'prefill'"}
        if phase == "prefill":
            return self._generate_prefill_only(rows, f)
        if self._service is None:
            code, out = self._generate_fused(rows, f)
            return code, (self._result(out["tokens"], text_mode)
                          if code == 200 else out)
        busy = self._adapter_busy(f)
        if busy is not None:
            return busy
        try:
            # every row is checked before any is queued: a refused row
            # leaves no orphaned work behind
            for row in rows:
                self._service.validate(row, f["max_new"], f["top_k"],
                                       f["top_p"], f["adapter"])
            sinks = [self._service.submit(
                row, f["max_new"], temperature=f["temperature"],
                seed=f["seed"] + i, eos_id=f["eos_id"], top_k=f["top_k"],
                top_p=f["top_p"], adapter=f["adapter"])
                for i, row in enumerate(rows)]
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
        return 200, self._result(outs, text_mode)

    def _generate_prefill_only(self, rows, f):
        """The sender half of disaggregation: prefill the one prompt row,
        sample its first token, and answer with the exported session
        (``{"migration": <base64>}``) for a decode replica's
        ``/migrate_in``, or with the tokens when the request finished at
        its first token."""
        if self._service is None or not self._service.can_migrate():
            return 400, {"Error": "phase='prefill' needs paged slot-pool "
                                  "serving (--slots + --page-size)"}
        if len(rows) != 1:
            return 400, {"Error": "phase='prefill' takes exactly one "
                                  "prompt row"}
        busy = self._adapter_busy(f)
        if busy is not None:
            return busy
        try:
            sink = self._service.submit_handoff(
                rows[0], f["max_new"], temperature=f["temperature"],
                seed=f["seed"], eos_id=f["eos_id"], top_k=f["top_k"],
                top_p=f["top_p"], adapter=f["adapter"])
        except ValueError as e:
            return 400, {"Error": str(e)}
        try:
            out = sink.get(timeout=600)
        except queue.Empty:
            return 504, {"Error": "prefill timed out"}
        if out is None:
            return 503, {"Error": "server shutting down"}
        if isinstance(out, BaseException):
            return 500, {"Error": f"generation failed: {out!r}"}
        with self._count_lock:
            self.requests_served += 1
            self.sequences_served += 1
            self.tokens_generated += 1      # the sampled first token
        if isinstance(out, tuple) and out[0] == "handoff":
            return 200, {"migration": migrate.encode_blob(out[1])}
        return 200, {"tokens": [out]}       # finished at activation

    def _generate_stream(self, body):
        refused = self._begin_request()
        if refused is not None:
            return refused
        try:
            out = self._generate_stream_impl(body)
        except BaseException:
            self._end_request()
            raise
        if not isinstance(out[1], StreamingBody):
            self._end_request()             # refused before streaming
            return out
        # in flight until the stream ends: done, aborted, disconnected,
        # or closed before its first chunk
        out[1].chunks = _CountedChunks(out[1].chunks, self._end_request)
        return out

    def _generate_stream_impl(self, body):
        """NDJSON streaming over the slot pool: ``{"delta": [...]}`` lines
        as rounds produce tokens, then ``{"done": [row]}``.  One prompt
        row; tokens only.  The served counts are taken when the batcher
        finishes the request, so an abandoned stream that ran still
        counts; a closed connection cancels it."""
        if self._service is None:
            return 400, {"Error": "streaming needs the slot pool; run "
                                  "with --slots"}
        rows, err = self._rows(body, 1)
        if err is not None:
            return err
        if len(rows) != 1:
            return 400, {"Error": "body must contain tokens: [[int, ...]] "
                                  "with exactly one row"}
        f, err = self._parse_gen_fields(body)
        if err is not None:
            return err
        busy = self._adapter_busy(f)
        if busy is not None:
            return busy
        row = rows[0]

        def on_complete(out):
            with self._count_lock:
                self.requests_served += 1
                self.sequences_served += 1
                self.tokens_generated += len(out) - len(row)

        try:
            sink = self._service.submit_stream(
                row, f["max_new"], temperature=f["temperature"],
                seed=f["seed"], eos_id=f["eos_id"], top_k=f["top_k"],
                top_p=f["top_p"], on_complete=on_complete,
                adapter=f["adapter"])
        except ValueError as e:
            return 400, {"Error": str(e)}

        def chunks():
            finished = False
            try:
                while True:
                    try:
                        kind, val = sink.get(timeout=600)
                    except queue.Empty:
                        yield (json.dumps({"Error": "timeout"})
                               + "\n").encode()
                        return
                    if kind == "delta":
                        yield (json.dumps({"delta": val}) + "\n").encode()
                        continue
                    finished = True
                    yield (json.dumps({"done": val} if kind == "done"
                                      else {"Error": "aborted"})
                           + "\n").encode()
                    return
            finally:
                # an abandoned stream (the client went away, or the sink
                # timed out) frees its slot instead of decoding for nobody
                if not finished:
                    self._service.cancel(sink)

        return 200, StreamingBody(chunks())

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
            # one program serves the prompt and the decode steps: phase
            # mixed; the guard closes after the host read
            with health.MONITOR.dispatch_guard("mixed", rows=len(rows)):
                out = generate_fused(
                    self.params, self.cfg,
                    torch.tensor(rows, dtype=torch.long, device=self.device),
                    max_new_tokens=f["max_new"],
                    temperature=f["temperature"], generator=gen,
                    eos_id=f["eos_id"]).tolist()
        outs = []
        for row, src in zip(out, rows):
            new = row[len(src):]
            if f["eos_id"] is not None and f["eos_id"] in new:
                row = row[:len(src) + new.index(f["eos_id"]) + 1]
            outs.append(row)
        new_tokens = sum(len(o) - len(r) for o, r in zip(outs, rows))
        # the slot pool counts these at submit and completion
        metrics.REQUESTS.inc(len(rows))
        metrics.GENERATED_TOKENS.inc(new_tokens)
        with self._count_lock:
            self.requests_served += 1
            self.sequences_served += len(rows)
            self.tokens_generated += new_tokens
        return 200, {"tokens": outs}

    def _score(self, body):
        return self._counted(self._score_impl, body)

    def _score_impl(self, body):
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
            # the mesh's batcher holds the split params; /score would run
            # the whole model on one device beside them
            return 400, {"Error": "/score is not mesh-aware yet; run "
                                  "without --tp to score"}
        with self._score_lock, health.MONITOR.dispatch_guard(
                "prefill", rows=len(rows)):
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
        dt = self._refresh_qps()
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
            "health": health.MONITOR.snapshot(),
        })
        if self._policy_client is not None:
            stats["policy"] = self._policy_client.snapshot()
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
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel degree over the visible cards "
                         "(0/1 = one card; on the CPU the device repeated); "
                         "requires --slots; /score is refused under it")
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
    ap.add_argument("--spill-bytes", type=int, default=0,
                    help="host-RAM byte budget of the KV spill tier (0 = "
                         "off; requires --slots and --page-size): an "
                         "admission past the pool's pages parks the "
                         "longest-resident session's KV in host RAM and "
                         "faults it back in when the queue is empty; "
                         "TPUSHARE_SPILL_IDLE_S sets the residency before "
                         "a session may spill")
    ap.add_argument("--adapter-slots", type=int, default=0,
                    help="multi-adapter LoRA pool: named adapters resident "
                         "at once (0 = off; requires --slots); /generate "
                         "takes \"adapter\": <name>, each row's adapter "
                         "is gathered inside the one batched forward, an "
                         "adapter loads on first use (weights drawn from "
                         "its name) and the LRU unpinned one makes room; "
                         "a name not resident against a fully pinned pool "
                         "answers 503 + Retry-After")
    ap.add_argument("--adapter-rank", type=int, default=8,
                    help="LoRA rank of the serving adapter pool (an "
                         "adapter costs rank*(d_in+d_out) a projection "
                         "and layer instead of a merged model copy)")
    ap.add_argument("--n-experts", type=int, default=0,
                    help="serve a mixture-of-experts variant of --model: "
                         "every --moe-every'th layer's FFN a routed block "
                         "of this many experts (0 = dense), inside the "
                         "same forwards on every storage and round flavor")
    ap.add_argument("--moe-top-k", type=int, default=1,
                    help="experts each token routes to in an MoE layer "
                         "(their router weights renormalised; needs "
                         "--n-experts)")
    ap.add_argument("--moe-every", type=int, default=1,
                    help="route every Nth layer's FFN through the experts, "
                         "counting from layer 0 (1 = all layers; needs "
                         "--n-experts)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="prompt tokens one mixed service round may "
                         "coalesce into its one prefill forward (0 = "
                         "two prefill chunks; requires --slots)")
    ap.add_argument("--sequential-prefill", action="store_true",
                    help="disable the mixed prefill+decode round: one "
                         "prefill forward per prefilling slot, then the "
                         "fused decode steps (the reference interleave; "
                         "requires --slots)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="prompt-lookup speculation depth (0 = off; "
                         "greedy-exact; requires --slots): while a greedy "
                         "request decodes, each round verifies the "
                         "pending token and K proposed ones in one "
                         "forward, on every slot storage; a windowed "
                         "page ring without the margin turns it off and "
                         "serves on")
    ap.add_argument("--policy", choices=("auto", "off"), default="auto",
                    help="tenant-isolation policy: 'auto' honours the node "
                         "daemon's /usage verdicts when the allocation env "
                         "carries TPUSHARE_STATUS_PORT (pace:<rate> paces "
                         "the device dispatches at the dispatch guard, "
                         "refuse answers 429 + Retry-After at admission), "
                         "and --pace-rate; 'off' ignores verdicts")
    ap.add_argument("--pace-rate", type=float, default=0.0,
                    help="static self-pacing in device-seconds per "
                         "wall-second (0 = none), without any daemon; a "
                         "daemon's pace verdict overrides it while "
                         "active and an ok verdict restores it")
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
    if args.spec_k and not args.slots:
        ap.error("--spec-k requires --slots")
    if args.tp > 1 and not args.slots:
        ap.error("--tp requires --slots")
    if args.spill_bytes and not (args.slots and args.page_size):
        ap.error("--spill-bytes requires --slots and --page-size")
    if args.adapter_slots and not args.slots:
        ap.error("--adapter-slots requires --slots")
    if (args.moe_top_k != 1 or args.moe_every != 1) and not args.n_experts:
        ap.error("--moe-top-k/--moe-every require --n-experts")
    if args.pace_rate and args.policy == "off":
        ap.error("--pace-rate needs the policy machinery; drop --policy "
                 "off")
    return args


def start_server(args: argparse.Namespace, env=None) -> LLMServer:
    """What a pod runs before it serves: the device plugin's env contract
    (``env``, default ``os.environ``) first — a placement failure raises
    :class:`~tpushare_torch.runtime.contract.AllocationFailed` before
    anything is built — then the CUDA allocator capped at the granted
    fraction, then the model and the server (bound, not yet serving).
    When ``env`` carries ``TPUSHARE_STATUS_PORT`` under an allocation,
    the server reports its usage to that daemon every
    ``TPUSHARE_USAGE_REPORT_S`` seconds (default 30), and with ``--policy
    auto`` a policy client applies the verdicts (or ``--pace-rate``
    alone arms it)."""
    e = env if env is not None else os.environ
    view = contract.enforce(e)
    device = default_device(args.device)
    contract.apply_memory_budget(e, device)
    if view.allocated:
        log.info("allocation: chip %s, %.1f%% of the card's memory",
                 view.chip_index, (view.hbm_fraction or 1.0) * 100)
    else:
        log.info("running unallocated (dev mode)")
    cfg, params = build_model(args.model, quantize_int8=args.int8,
                              seed=args.seed, quantize_int4=args.int4,
                              kv_dtype=args.kv_dtype,
                              attn_kernel=args.attn_kernel, device=device,
                              n_experts=args.n_experts,
                              moe_top_k=args.moe_top_k,
                              moe_every=args.moe_every)
    reporting = bool(view.allocated and e.get("TPUSHARE_STATUS_PORT"))
    interval = float(e.get("TPUSHARE_USAGE_REPORT_S", "30"))
    policy_client = None
    if args.policy != "off" and (args.pace_rate > 0 or reporting):
        policy_client = PolicyClient(static_rate=args.pace_rate or None,
                                     verdict_interval_s=interval)
    srv = LLMServer(cfg, params, port=args.port, addr=args.addr,
                    n_slots=args.slots, page_size=args.page_size,
                    n_pages=args.kv_pages, device=device,
                    pool_bytes=args.kv_pool_bytes or None, sp=args.sp,
                    tp=args.tp,
                    prefix_cache=args.prefix_cache,
                    prefill_budget=args.prefill_budget,
                    mixed_step=not args.sequential_prefill,
                    spec_k=args.spec_k, policy_client=policy_client,
                    spill_bytes=args.spill_bytes,
                    adapter_slots=args.adapter_slots,
                    adapter_rank=args.adapter_rank)
    if reporting:
        srv.start_usage_reports(env=e, interval_s=interval)
        log.info("usage reporting to the daemon every %.0fs (policy: %s)",
                 interval, args.policy)
    log.info("llm server: model=%s weights=%s kv_dtype=%s attn_kernel=%s "
             "experts=%d device=%s on %s:%d", args.model,
             "int8" if args.int8 else "int4" if args.int4 else "bf16",
             cfg.kv_dtype, cfg.attn_kernel, args.n_experts, srv.device,
             args.addr, srv.port)
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
