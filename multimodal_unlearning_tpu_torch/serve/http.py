"""Minimal HTTP serving front end over the continuous-batching engine.

Counterpart of ``multimodal_unlearning_tpu/serve/http.py``: an
OpenAI-completions-shaped HTTP API over ``serve.engine.ServingEngine``
using only the standard library (no web framework needed), so a user can
stand up a local inference endpoint for the unlearned checkpoints.

Design: `ThreadingHTTPServer` handlers never touch the engine — they
enqueue a work item and block on its `threading.Event`.  One engine
thread owns the engine exclusively: it admits queued submissions, calls
``engine.step()`` while anything is in flight, and sets each item's event
when its request completes.  The engine itself stays single-threaded, the
handlers are thin, and throughput properties (continuous batching,
speculation, the prefix cache, the paged KV cache, multi-LoRA, sampling)
are exactly the engine's.

Endpoints:
  POST /v1/completions   {"prompt": str, "max_tokens"?, "adapter"?,
                          "sample_seed"?, "stop"?, "draft"?, "stream"?}
                          -> {"text", "tokens", "adapter", "ttft_s",
                          "latency_s"} (+ "logprobs": {"token_logprobs"}
                          when the engine keeps them), or an SSE stream
  GET  /v1/stats         engine.stats() + queue depth
  GET  /health           200 once the engine thread is live

Sampling is the engine's setting: a request's "temperature" is ignored, as
in the JAX package.  An unknown "adapter" answers 400.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _apply_stops(text: str, stops: list) -> tuple[str, bool]:
    """Truncate at the earliest stop-string occurrence (OpenAI semantics).
    The single source of stop-cut truth for the engine thread's watch, the blocking
    response, and the SSE stream."""
    cuts = [text.find(s) for s in stops if s in text]
    if cuts:
        return text[: min(cuts)], True
    return text, False


class _Work:
    __slots__ = ("payload", "event", "request", "error", "stops", "text",
                 "abandoned")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.request = None
        self.error = None
        stops = payload.get("stop") or []
        self.stops = [stops] if isinstance(stops, str) else list(stops)
        self.text = None  # set when a stop string truncates the stream
        self.abandoned = False  # streaming client gone: the engine thread cancels it


class EngineServer:
    """Own an engine on an engine thread; serve HTTP on a ThreadingHTTPServer.

    Args:
      engine: a ServingEngine.
      encode: text -> prompt token ids (chat template included).
      decode: token ids -> text.
      default_max_tokens: budget when a request omits ``max_tokens``.
    """

    def __init__(self, engine, encode, decode, *, default_max_tokens: int = 128):
        self.engine = engine
        self.encode = encode
        self.decode = decode
        self.default_max_tokens = default_max_tokens
        self._inbox: list[_Work] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._drive, daemon=True)
        self._httpd = None

    # ------------------------------------------------------- engine thread
    def _drive(self):
        pending: list[_Work] = []
        while not self._stop:
            with self._lock:
                fresh, self._inbox = self._inbox, []
            self._wake.clear()
            for w in fresh:
                try:
                    p = w.payload
                    ids = self.encode(str(p["prompt"]))
                    dref = self.encode(str(p["draft"])) if p.get("draft") else None
                    w.request = self.engine.submit(
                        ids, int(p.get("max_tokens", self.default_max_tokens)),
                        draft_ref=dref,
                        sample_seed=p.get("sample_seed"),
                        adapter=p.get("adapter"),
                    )
                except Exception as e:  # bad payload: report, don't kill the loop
                    w.error = e
                    w.event.set()
                pending.append(w)
            in_flight = any(w.request is not None and not w.request.done
                            for w in pending)
            if in_flight or any(
                    r is not None for r in self.engine._slot_req) or self.engine._queue:
                self.engine.step()
                # TEXT-level stop strings (OpenAI semantics): token-id
                # matching misses BPE boundary merges, so decode each
                # watched stream and cancel at the earliest stop occurrence.
                # Abandoned streams (client gone / deadline) cancel here too:
                # the ENGINE is single-owner — only this thread may touch it.
                for w in pending:
                    r = w.request
                    if r is None or r.done:
                        continue
                    if w.abandoned:
                        self.engine.cancel(r)
                        continue
                    if not w.stops or w.text is not None:
                        continue
                    text, hit = _apply_stops(self.decode(r.tokens), w.stops)
                    if hit:
                        w.text = text
                        self.engine.cancel(r)
            else:
                # idle: sleep until a handler enqueues work
                self._wake.wait(timeout=0.05)
            done = [w for w in pending
                    if w.request is not None and w.request.done and not w.event.is_set()]
            for w in done:
                w.event.set()
            pending = [w for w in pending if not w.event.is_set()]
        # unblock anyone still waiting at shutdown
        for w in pending:
            w.error = RuntimeError("server shut down")
            w.event.set()

    # ---------------------------------------------------------------- api
    def submit_work(self, payload: dict) -> "_Work":
        """Thread-safe: enqueue a completion and return its handle without
        waiting (the streaming path polls ``w.request.tokens`` growth)."""
        w = _Work(payload)
        with self._lock:
            self._inbox.append(w)
        self._wake.set()
        return w

    def submit(self, payload: dict, timeout: float | None = None) -> dict:
        """Thread-safe: enqueue one completion request and wait for it."""
        w = self.submit_work(payload)
        if not w.event.wait(timeout):
            raise TimeoutError("completion timed out")
        if w.error is not None:
            raise w.error
        r = w.request
        text = w.text if w.text is not None else self.decode(r.tokens)
        # a stop may land inside the final consumed chunk after the request
        # already finished — truncate here too
        text, _ = _apply_stops(text, w.stops)
        out = {
            "text": text,
            "tokens": len(r.tokens),
            "adapter": payload.get("adapter"),
            "ttft_s": round(r.first_t - r.submit_t, 4),
            "latency_s": round(r.done_t - r.submit_t, 4),
        }
        if self.engine.want_lp:
            # OpenAI-completions shape: one logprob per emitted token
            out["logprobs"] = {"token_logprobs": [round(x, 6) for x in r.logprobs]}
        return out

    def stats(self) -> dict:
        st = dict(self.engine.stats())
        with self._lock:
            st["queued"] = len(self._inbox)
        return st

    # --------------------------------------------------------------- http
    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Start the engine thread + HTTP server; returns (host, port)."""
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"ok": outer._thread.is_alive()})
                elif self.path == "/v1/stats":
                    self._send(200, outer.stats())
                else:
                    self._send(404, {"error": "not found"})

            def _stream(self, payload):
                """SSE streaming ('stream': true): flush text deltas as the
                engine thread lands tokens; a stop string or cancellation
                ends the stream at the truncation point.

                Contract details: headers are already sent when anything can
                fail, so errors become a ``data: {"error": ...}`` event (a
                second HTTP response would corrupt the stream).  Deltas are
                withheld while the decoded tail is unstable (a trailing
                U+FFFD from a token mid-multi-byte-sequence, or a decode
                that doesn't extend what was sent) so concatenated deltas
                always equal the final text.  On deadline or client
                disconnect the work is marked abandoned — the engine thread
                cancels it (single-owner engine), freeing the slot."""
                import time as _time

                w = outer.submit_work(payload)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()

                def event(obj):
                    self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
                    self.wfile.flush()

                sent = ""
                deadline = _time.monotonic() + 600
                try:
                    while True:
                        if w.error is not None:
                            event({"error": f"{type(w.error).__name__}: {w.error}"})
                            break
                        r = w.request
                        done = w.event.is_set() or (r is not None and r.done)
                        if r is not None:
                            text = (w.text if w.text is not None
                                    else outer.decode(r.tokens))
                            text, _hit = _apply_stops(text, w.stops)
                            if not done and text.endswith("�"):
                                # token ends mid multi-byte sequence: hold
                                # back until the next token completes it
                                text = text[: -1]
                            if text != sent:
                                if text.startswith(sent):
                                    event({"text": text[len(sent):]})
                                    sent = text
                                elif done:
                                    # decode revised earlier chars: final
                                    # authoritative replacement
                                    event({"text": text, "restart": True})
                                    sent = text
                                # else: unstable mid-stream decode — wait
                        if done:
                            break
                        if _time.monotonic() > deadline:
                            w.abandoned = True  # the engine thread cancels + frees the slot
                            event({"error": "stream timed out"})
                            break
                        _time.sleep(0.01)
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    w.abandoned = True  # client gone: the engine thread cancels

            def do_POST(self):
                if self.path != "/v1/completions":
                    return self._send(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if "prompt" not in payload:
                        return self._send(400, {"error": "missing 'prompt'"})
                    if payload.get("stream"):
                        try:
                            return self._stream(payload)
                        except Exception:
                            # SSE headers may already be on the wire — a
                            # second HTTP response would corrupt the stream
                            return
                    self._send(200, outer.submit(payload, timeout=600))
                except (KeyError, ValueError) as e:
                    self._send(400, {"error": str(e)})
                except NotImplementedError as e:
                    self._send(501, {"error": str(e)})
                except Exception as e:
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        self._thread.start()
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self._httpd.server_address

    def shutdown(self):
        self._stop = True
        self._wake.set()
        if self._httpd is not None:
            self._httpd.shutdown()
        self._thread.join(timeout=10)
