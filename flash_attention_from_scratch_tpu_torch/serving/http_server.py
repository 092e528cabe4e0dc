"""Minimal HTTP frontend over GenerationServer (stdlib only).

Counterpart of ``flash_attention_from_scratch_tpu/serving/http_server.py``,
with the same routes:

POST /generate   {"prompt": [ids...], "max_new_tokens": N,
                  "stop": [ids...]?}           -> {"id", "tokens"}
                 or, with a tokenizer attached, {"text": "...", ...}
                 -> {"id", "tokens", "text"}.
                 (blocks until the request finishes; the background step
                 loop keeps batching other requests meanwhile)
GET  /stats      -> GenerationServer.stats() + queue depths
GET  /health     -> {"ok": true}

One background thread drives ``server.step()`` whenever work exists; HTTP
handler threads only enqueue and wait. So every CUDA call, the captures of
the server's CUDA graphs included, runs on that one thread: a capture in
the default (global) mode fails if another thread touches CUDA while it
runs. Token ids in, token ids out: tokenizers are a client concern.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .generate import GenerationServer

__all__ = ["ServingFrontend"]


class ServingFrontend:
    """Own a GenerationServer and its step loop; serve HTTP on demand."""

    def __init__(self, server: GenerationServer, tokenizer=None):
        """``tokenizer``: optional object with ``encode(str) -> [ids]`` and
        ``decode([ids]) -> str`` (a transformers tokenizer fits), enabling
        the text-in/text-out request form."""
        self.server = server
        self.tokenizer = tokenizer
        self._lock = threading.Lock()       # guards submit and seqs access
        self._done = {}                     # sid -> tokens
        self._events = {}                   # sid -> threading.Event
        self._next_id = 1
        self._stop = threading.Event()
        self._fatal: Exception | None = None
        self._loop = threading.Thread(target=self._run_loop, daemon=True)
        self._loop.start()

    def _run_loop(self):
        while not self._stop.is_set():
            try:
                with self._lock:
                    has_work = self.server.has_work
                    if has_work:
                        for sid in self.server.step():
                            self._done[sid] = list(self.server.seqs[sid].generated)
                            # A finished sequence never decodes again: drop
                            # its state, or a long-running frontend keeps
                            # one per request forever.
                            del self.server.seqs[sid]
                            ev = self._events.pop(sid, None)
                            if ev is not None:
                                ev.set()
            except Exception as e:  # noqa: BLE001 - a dead loop would strand
                # every request with /health still green: record, wake all
                # waiters, and stop.
                logging.getLogger(__name__).error(
                    "serving step loop died:\n%s", traceback.format_exc())
                self._fatal = e
                with self._lock:
                    for ev in self._events.values():
                        ev.set()
                    self._events.clear()
                return
            if not has_work:
                time.sleep(0.002)

    def submit(self, prompt, max_new_tokens: int, stop=()):
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            ev = threading.Event()
            self._events[sid] = ev
            self.server.submit(sid, list(prompt), max_new_tokens, stop=tuple(stop))
        return sid, ev

    def generate(self, prompt, max_new_tokens: int, stop=(), timeout: float = 600.0):
        sid, ev = self.submit(prompt, max_new_tokens, stop)
        try:
            if not ev.wait(timeout):
                raise TimeoutError(f"request {sid} did not finish in {timeout}s")
            if self._fatal is not None:
                raise RuntimeError(f"serving loop died: {self._fatal!r}")
            return sid, self._done.pop(sid)
        finally:
            # A timed-out or failed request must not strand its event or
            # its late result.
            with self._lock:
                self._events.pop(sid, None)
                self._done.pop(sid, None)

    def stats(self):
        with self._lock:
            out = self.server.stats()
        out["pending_results"] = len(self._done)
        return out

    def shutdown(self):
        self._stop.set()
        self._loop.join(timeout=5)

    # -- HTTP ---------------------------------------------------------------

    def make_http_server(self, host: str = "127.0.0.1", port: int = 8000):
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    ok = frontend._fatal is None
                    return self._reply(200 if ok else 500, {
                        "ok": ok, "error": None if ok else repr(frontend._fatal)})
                if self.path == "/stats":
                    return self._reply(200, frontend.stats())
                return self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/generate":
                    return self._reply(404, {"error": "unknown path"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    if "text" in req:
                        if frontend.tokenizer is None:
                            return self._reply(400, {"error": "no tokenizer attached"})
                        prompt = list(frontend.tokenizer.encode(req["text"]))
                    else:
                        prompt = [int(t) for t in req["prompt"]]
                    sid, toks = frontend.generate(
                        prompt, int(req.get("max_new_tokens", 16)),
                        stop=tuple(req.get("stop", ())))
                    out = {"id": sid, "tokens": toks}
                    if frontend.tokenizer is not None:
                        out["text"] = frontend.tokenizer.decode(toks)
                    return self._reply(200, out)
                except Exception as e:  # noqa: BLE001 - surface to the client
                    return self._reply(400, {"error": str(e)})

            def log_message(self, *a):  # quiet
                pass

        return ThreadingHTTPServer((host, port), Handler)
