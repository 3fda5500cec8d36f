"""Async serving loop over the bucketed engines (port of
``repro/serving/server.py``; the VGGT engine is the one ported so far).

The engines (``serving.vggt_engine.VGGTEngine`` for feed-forward scenes;
the LM engine waits for its port) are deliberately single-threaded and
deterministic: ``enqueue`` coalesces, ``poll`` applies the ``max_wait_s``
deadline, ``flush`` drains.  The ``AsyncServer`` wraps one in the
production serving loop:

* a **background thread** calls ``engine.poll()`` on a timer, so a
  half-full micro-batch group is flushed the moment its oldest request
  passes the deadline — callers never have to drive the queue;
* a thread-safe **submit/await interface**: ``submit(...)`` forwards to
  ``engine.enqueue`` under the engine lock and attaches a waiter event;
  ``result(req)`` blocks until the loop (or an auto-flush on a later
  submit) delivers.

All engine work runs under one lock — the engines are the unit of
serialization (one device stream), the server is the unit of liveness.
A lock is not fair, and a continuous engine with busy decode slots has
the loop re-take it burst after burst; so callers other than the loop
register while they wait (``_engine_lock``), and the loop lets them in
before its next burst — a request submitted mid-decode joins the running
batch instead of waiting for it to drain.

    eng = VGGTEngine(cfg, params, tiers=tiers, max_wait_s=0.002)
    with AsyncServer(eng) as srv:
        reqs = [srv.submit(scenes, tier="fast") for scenes in batches]
        outs = [srv.result(r, timeout=60) for r in reqs]

With ``metrics_port=`` the server additionally exposes the telemetry
endpoints (``docs/observability.md``):

* ``GET /metrics`` — Prometheus text exposition (engine stats published
  at scrape time, kernel launch counters, quant health);
* ``GET /stats``   — the engine's unified ``summary()`` JSON plus
  queue-depth gauges;
* ``GET /trace``   — the recent span-event ring buffer as JSON
  (``?request=r42`` filters one chain, ``?n=100`` bounds the tail);
* ``GET /healthz`` — liveness: ``ok`` / ``degraded`` (loop striking
  out, or the engine's degradation ladder is active) / ``unhealthy``
  (503; the loop failed permanently — see ``max_loop_failures``).

``metrics_port=0`` binds an ephemeral port (see ``metrics_address``).
Starting with a metrics port turns live telemetry on process-wide
(``obs.enable_all()``) so span chains and quant health are recorded for
the traffic being scraped.
"""
from __future__ import annotations

import contextlib
import http.server
import json
import threading
import time
import urllib.parse
from typing import Any, Optional

from repro_torch import obs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.batching import LOOP_THREAD, PendingRequest, ServerStopped, ServingEngine

__all__ = ["AsyncServer"]


class _ObsHandler(http.server.BaseHTTPRequestHandler):
    server_version = "repro-obs/1"

    def log_message(self, *args) -> None:  # silence per-request stderr spam
        pass

    def do_GET(self) -> None:
        srv: "AsyncServer" = self.server.async_server  # type: ignore[attr-defined]
        url = urllib.parse.urlsplit(self.path)
        code = 200
        try:
            if url.path == "/metrics":
                body = srv._render_metrics().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif url.path == "/stats":
                body = json.dumps(srv._render_stats(), indent=2).encode()
                ctype = "application/json"
            elif url.path == "/trace":
                q = urllib.parse.parse_qs(url.query)
                n = int(q["n"][0]) if "n" in q else 256
                request = q.get("request", [None])[0]
                body = json.dumps(srv._render_trace(n, request), indent=2).encode()
                ctype = "application/json"
            elif url.path == "/healthz":
                code, status = srv.health()
                body, ctype = (status + "\n").encode(), "text/plain"
            else:
                self.send_error(404, "unknown path (try /metrics /stats /trace)")
                return
        except Exception as e:  # surface render bugs to the scraper, not a hang
            self.send_error(500, f"{type(e).__name__}: {e}")
            return
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class AsyncServer:
    """Background scheduling loop + thread-safe submit/await over one
    serving engine (anything implementing the
    ``batching.ServingEngine`` protocol — LM or VGGT)."""

    def __init__(
        self,
        engine: ServingEngine,
        poll_interval_s: Optional[float] = None,
        *,
        metrics_port: Optional[int] = None,
        metrics_host: str = "127.0.0.1",
        registry: Optional[obs_metrics.Registry] = None,
        max_loop_failures: int = 8,
    ):
        missing = [
            m for m in ("enqueue", "poll", "flush", "abort")
            if not callable(getattr(engine, m, None))
        ]
        if missing:
            raise TypeError(
                f"{type(engine).__name__} does not implement the "
                f"ServingEngine protocol (missing {missing})"
            )
        self.engine = engine
        self.metrics_port = metrics_port
        self.metrics_host = metrics_host
        self.registry = registry if registry is not None else obs_metrics.default()
        self._http: Optional[http.server.ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        if poll_interval_s is None:
            # pace the loop off the engine's own deadline: ~4 polls per
            # max_wait_s window bounds flush lateness at 25% of the
            # deadline without spinning a 1 kHz wakeup on an idle server
            wait = getattr(engine, "max_wait_s", 0.004)
            poll_interval_s = min(max(wait / 4, 0.001), 0.05)
        self.poll_interval_s = poll_interval_s
        # fail-fast accounting for the poll loop (docs/robustness.md):
        # K consecutive poll failures escalate to abort() + unhealthy
        self.max_loop_failures = max_loop_failures
        self.loop_failures = 0  # total across the server's lifetime
        self.consecutive_failures = 0
        self.last_error: Optional[BaseException] = None
        self._failed = False
        self._lock = threading.Lock()
        self._waiting = 0  # callers blocked on _lock other than the loop
        self._waiting_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @contextlib.contextmanager
    def _engine_lock(self):
        """The engine lock for every caller but the poll loop, counted in
        ``_waiting`` until it is held (a ``lock_wait`` span), so that the
        loop yields it."""
        with self._waiting_lock:
            self._waiting += 1
        try:
            with obs_trace.span("lock_wait"):
                self._lock.acquire()
        finally:
            with self._waiting_lock:
                self._waiting -= 1
        try:
            yield
        finally:
            self._lock.release()

    # ---- lifecycle -------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "AsyncServer":
        if not self.running:
            # each loop gets its own stop event: if a previous stop()'s
            # join timed out (poll stuck in a long forward), the old
            # thread still holds a set event and exits on its next check
            # instead of being resurrected by a clear()
            self._stop = stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, args=(stop,), name=LOOP_THREAD, daemon=True
            )
            self._thread.start()
        if self.metrics_port is not None and self._http is None:
            # a metrics surface implies live telemetry: span chains and
            # quant health must be recorded for the traffic it reports on
            obs.enable_all(registry=None if self.registry is obs_metrics.default()
                           else self.registry)
            self._http = http.server.ThreadingHTTPServer(
                (self.metrics_host, self.metrics_port), _ObsHandler
            )
            self._http.daemon_threads = True
            self._http.async_server = self  # type: ignore[attr-defined]
            self._http_thread = threading.Thread(
                target=self._http.serve_forever, name="obs-http", daemon=True
            )
            self._http_thread.start()
        return self

    @property
    def metrics_address(self) -> Optional[tuple[str, int]]:
        """(host, port) the telemetry endpoints are bound to (resolves
        ``metrics_port=0`` to the ephemeral port), or None."""
        if self._http is None:
            return None
        return self._http.server_address[:2]

    def stop(self, drain: bool = True) -> None:
        """Stop the loop.  With ``drain`` (default) flush every pending
        group first; without it, queued requests are *failed* so their
        waiters wake with an error instead of blocking forever."""
        try:
            with self._engine_lock():
                if drain:
                    try:
                        self.engine.flush()
                    except BaseException:
                        # one failing group must not strand the others:
                        # flush() stops at the first error, so fail every
                        # still-queued request (their waiters wake with an
                        # error, not a full timeout), then propagate
                        self.engine.abort(ServerStopped("server drain failed"))
                        raise
                else:
                    self.engine.abort(ServerStopped("server stopped before drain"))
        finally:
            # a failing drain flush (micro-batch error re-raised after
            # _fail-ing its owners) must still shut the loop down
            self._stop.set()
            if self._http is not None:
                self._http.shutdown()
                self._http.server_close()
                self._http = None
                self._http_thread = None
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                if not self._thread.is_alive():
                    self._thread = None
                # else: the loop is stuck inside a long engine call; it
                # will see its (set) stop event and exit on return —
                # `running` stays True until then so start() can't
                # double-spawn

    def __enter__(self) -> "AsyncServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    # ---- submit/await ----------------------------------------------------

    def submit(self, *args, **kwargs) -> PendingRequest:
        """Thread-safe ``engine.enqueue(...)``; returns the pending
        request with a waiter attached (an auto-flush may already have
        delivered it).  Raises :class:`ServerStopped` once the poll loop
        has failed permanently (``max_loop_failures`` strikes).

        Traced as a ``submit`` span (label ``req``: the request id) whose
        children are the ``lock_wait`` and any engine call it ran."""
        if self._failed:
            raise ServerStopped(
                f"server loop failed permanently after "
                f"{self.max_loop_failures} consecutive poll failures "
                f"(last error: {self.last_error!r})"
            )
        with obs_trace.span("submit") as sp, self._engine_lock():
            req = self.engine.enqueue(*args, **kwargs)
            if not req.ready:
                # attached under the lock so the loop's delivery can never
                # race past an unobserved event
                req._event = threading.Event()
            if sp is not None:
                sp.labels["req"] = req.req_id
        return req

    def result(self, req: PendingRequest, timeout: float | None = None) -> Any:
        """Block until the request's micro-batch is flushed; raises
        ``TimeoutError`` after ``timeout`` seconds."""
        if not req.ready:
            if req._event is None or not req._event.wait(timeout):
                if not req.ready:  # re-check: delivery may have just landed
                    raise TimeoutError(
                        f"request not served within {timeout}s (server "
                        f"{'running' if self.running else 'stopped'})"
                    )
        return req.result()

    # ---- telemetry endpoints ---------------------------------------------

    def _publish(self) -> None:
        """Refresh the registry from the engine under the engine lock —
        scrape-time publishing keeps the serving hot path free of registry
        traffic and a scrape coherent with the stats tables."""
        with self._engine_lock():
            self.engine.stats.publish(self.registry)
            pending = getattr(self.engine, "pending", 0)
            active = getattr(self.engine, "active", 0)
        kind = getattr(self.engine.stats, "kind", "generic")
        self.registry.gauge(
            "serve_pending_requests", "requests waiting for admission", ("kind",)
        ).set(pending, kind=kind)
        self.registry.gauge(
            "serve_active_rows", "decode-slot rows mid-generation", ("kind",)
        ).set(active, kind=kind)

    def _render_metrics(self) -> str:
        self._publish()
        return self.registry.render_prometheus()

    def _render_stats(self) -> dict:
        with self._engine_lock():
            summary = self.engine.stats.summary()
            summary["pending"] = getattr(self.engine, "pending", 0)
            summary["active"] = getattr(self.engine, "active", 0)
        return summary

    def _render_trace(self, n: int, request: Optional[str]) -> list[dict]:
        tr = obs_trace.current()
        if tr is None:
            return []
        return [ev.to_dict() for ev in tr.recent(n=n, request=request)]

    # ---- health ----------------------------------------------------------

    def health(self) -> tuple[int, str]:
        """(http_code, status) for ``/healthz``: ``(200, "ok")``,
        ``(200, "degraded")`` while the poll loop is striking out or the
        engine's degradation ladder is active, ``(503, "unhealthy")``
        once the loop has failed permanently."""
        if self._failed:
            return 503, "unhealthy"
        if (
            self.consecutive_failures > 0
            or getattr(self.engine, "degradation_level", 0) > 0
        ):
            return 200, "degraded"
        return 200, "ok"

    # ---- loop ------------------------------------------------------------

    def _record_loop_failure(self, e: Exception) -> bool:
        """Count one poll failure; returns True when the loop must stop
        (K consecutive strikes — fail fast, don't loop silently)."""
        self.loop_failures += 1
        self.consecutive_failures += 1
        self.last_error = e
        self.registry.counter(
            "serve_loop_failures_total",
            "poll-loop failures survived by the async server", ("error",),
        ).inc(error=type(e).__name__)
        obs_trace.emit(
            "loop_failure", error=type(e).__name__,
            consecutive=self.consecutive_failures,
        )
        return self.consecutive_failures >= self.max_loop_failures

    def _loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            busy = False
            try:
                with self._lock:
                    busy = self.engine.poll() > 0
                    # a continuous engine with occupied decode slots wants
                    # back-to-back bursts, not timer-paced ones — sleeping
                    # between bursts would serialize decode on the poll
                    # interval and collapse tokens/s
                    busy = busy or getattr(self.engine, "active", 0) > 0
                self.consecutive_failures = 0
            except Exception as e:
                # flush_group already _fail-ed every owner of a broken
                # micro-batch; the loop survives to keep serving the other
                # groups' deadlines — but every failure is recorded, and K
                # consecutive strikes escalate instead of spinning forever
                if self._record_loop_failure(e):
                    self._failed = True
                    err = ServerStopped(
                        f"server poll loop aborted after "
                        f"{self.consecutive_failures} consecutive failures "
                        f"(last error: {e!r})"
                    )
                    try:
                        with self._lock:
                            self.engine.abort(err)
                    except Exception:
                        pass  # abort is best-effort on the way down
                    break
            # waiting callers take the lock before the next burst
            while self._waiting and not stop.is_set():
                time.sleep(0)
            stop.wait(0.0 if busy else self.poll_interval_s)
