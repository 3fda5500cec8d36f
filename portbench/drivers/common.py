"""What every driver shares: the traffic loops through the server's
``submit``/``result``, the traced run's span tracer and profiled
sub-window, and the host-clock record of each engine call."""
from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Callable

from portbench.harness import CLOCK_FIELDS, Batch, Req, Run, power_line
from portbench.devtrace import SubWindow

WAIT_PAST_CLOSE_S = 60.0


class Window:
    """The measured window: its origin on the host clock and, in a traced
    run, the tracer and the profiled sub-window at its end."""

    def __init__(self, run: Run):
        self.run = run
        self.t0 = None
        self.tracer = None
        self.sub = None
        self.pauses = None
        self.alloc = {}

    def open(self) -> float:
        from repro_torch.obs import trace as obs_trace

        if self.run.trace:
            warm_profiler()  # its first start initialises the device tracer (~2 s)
            self.tracer = obs_trace.Tracer(capacity=1_000_000)
            obs_trace.install(self.tracer)
        self.pauses = GcPauses()
        gc.callbacks.append(self.pauses)
        self.alloc = alloc_counters()
        self.t0 = time.perf_counter()
        if self.run.trace:
            T = self.run.window_s
            lead = min(float(self.run.traffic["profile_s"]), T)
            self.sub = SubWindow(self.t0 + T - lead, self.t0 + T, self.t0)
            self.sub.start()
        return self.t0

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def close(self) -> None:
        """After the traffic: the tracer's events and the profile."""
        from repro_torch.obs import trace as obs_trace

        if self.sub is not None:
            self.sub.join()
            self.run.profile = self.sub.reduce()
            if self.run.profile.get("error"):
                self.run.notes.append(f"profile: {self.run.profile['error']}")
        if self.tracer is not None:
            obs_trace.uninstall()
            self.run.events = [dict(ev.to_dict(), t=ev.t - self.t0)
                               for ev in self.tracer.recent()]
        gc.callbacks.remove(self.pauses)
        self.run.notes.append(self.stalls())
        if self.alloc:  # a CUDA run
            self.run.notes.append(f"card at the close ({CLOCK_FIELDS}): {power_line(CLOCK_FIELDS)}")

    def stalls(self) -> str:
        """What can stall a window on the host: collector pauses, the
        caching allocator's retries and fresh device allocations, and the
        longest gap between engine calls."""
        p, now = self.pauses, alloc_counters()
        more = {k: now[k] - self.alloc[k] for k in now}
        calls = sorted(self.run.batches, key=lambda b: b.t0)
        gap, at = max(((b.t0 - a.t1, a.t1) for a, b in zip(calls, calls[1:])),
                      default=(0.0, 0.0))
        return (f"stalls: gc {p.n} pauses, {p.total:.3f} s, longest {p.longest:.3f} s; "
                f"allocator retries {more.get('num_alloc_retries', 0)}, device allocations "
                f"{more.get('num_device_alloc', 0)}; longest gap between engine calls "
                f"{gap:.3f} s at {at:.1f} s")


class GcPauses:
    """Garbage-collector pauses, as a ``gc.callbacks`` entry."""

    def __init__(self):
        self.start = None
        self.n, self.total, self.longest = 0, 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self.start = time.perf_counter()
        elif self.start is not None:
            d = time.perf_counter() - self.start
            self.n, self.total, self.longest = self.n + 1, self.total + d, max(self.longest, d)
            self.start = None


def alloc_counters() -> dict:
    import torch

    if not torch.cuda.is_available():
        return {}
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc")}


def warm_profiler() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.empty(1)


def record_calls(cls, name: str, window: Window, describe: Callable) -> Callable[[], None]:
    """Wrap ``cls.name`` (one engine call: a micro-batch or a prefill wave)
    so that each call appends a ``Batch`` with its host-clock span, which
    ends after the engine's synchronise, to ``window.run.batches``.
    ``describe(self, args, kwargs, result)`` gives the Batch's other fields.
    Returns the undo."""
    orig = getattr(cls, name)

    def wrapped(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = orig(self, *args, **kwargs)
        t1 = time.perf_counter()
        if window.t0 is not None:
            window.run.batches.append(Batch(t0=t0 - window.t0, t1=t1 - window.t0,
                                            **describe(self, args, kwargs, out)))
        return out

    setattr(cls, name, wrapped)
    return lambda: setattr(cls, name, orig)


def open_loop(srv, window: Window, reqs: list[Req], make: Callable, submit_kw: dict,
              keep: Callable) -> None:
    """Submit each request at its due time from this thread; a collector
    thread waits for the results in order (one micro-batch group, so
    delivery is in order).  ``make(req)`` builds a request's input ahead of
    its due time; ``keep(req, out)`` takes what the check needs."""
    pending: queue.Queue = queue.Queue()
    close = window.run.window_s + WAIT_PAST_CLOSE_S

    def collect():
        while True:
            item = pending.get()
            if item is None:
                return
            r, handle = item
            try:
                out = srv.result(handle, timeout=max(0.1, close - window.now()))
                r.done = window.now()
                r.ok = True
                keep(r, out)
            except Exception as e:  # failed, refused or never delivered: missing
                r.done, r.error = window.now(), repr(e)

    collector = threading.Thread(target=collect, name="portbench-collector", daemon=True)
    collector.start()
    t0 = window.t0
    nxt = make(reqs[0]) if reqs else None
    for i, r in enumerate(reqs):
        x = nxt
        time.sleep(max(0.0, t0 + r.due - time.perf_counter()))
        r.sent = window.now()
        try:
            handle = srv.submit(x, **submit_kw)
            r.req_id = handle.req_id
            pending.put((r, handle))
        except Exception as e:
            r.done, r.error = window.now(), repr(e)
        del x
        nxt = make(reqs[i + 1]) if i + 1 < len(reqs) else None
    pending.put(None)
    collector.join()


def closed_loop(srv, window: Window, clients: int, make: Callable, submit_kw: Callable,
                keep: Callable) -> list[Req]:
    """``clients`` threads, each sending its next request when the last
    came back, until the window closes.  ``make(client, seq)`` returns a
    (Req, input) pair; ``submit_kw(req)`` the submit's keyword arguments."""
    out: list[list[Req]] = [[] for _ in range(clients)]
    close = window.run.window_s + WAIT_PAST_CLOSE_S

    def client(c):
        seq = 0
        while window.now() < window.run.window_s:
            r, x = make(c, seq)
            r.sent = window.now()
            out[c].append(r)
            try:
                handle = srv.submit(x, **submit_kw(r))
                r.req_id = handle.req_id
                res = srv.result(handle, timeout=max(0.1, close - window.now()))
                r.done = window.now()
                r.ok = True
                keep(r, res)
            except Exception as e:
                r.done, r.error = window.now(), repr(e)
            del x
            seq += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"portbench-client{c}",
                                daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [r for rs in out for r in rs]


def sample(reqs: list[Req], n: int, seed: int, longest: Callable = None,
           slot: Callable = None) -> list[Req]:
    """At least ``n`` of the completed requests, drawn from the seed: the
    longest (by ``longest``) among them, and one from each row of an engine
    call (``slot``: a request's row, or None) that any of them took, so a
    fault confined to some rows of a batch is sampled whatever the seed."""
    from portbench.traffic import rng

    done = [r for r in reqs if r.ok]
    if not done:
        return []
    order = [done[i] for i in rng(seed, 9).permutation(len(done))]
    picks = [max(done, key=longest)] if longest is not None else []
    if slot is not None:
        rows = {slot(r) for r in done} - {slot(r) for r in picks} - {None}
        picks += [next(r for r in order if slot(r) == row) for row in sorted(rows)]
    picks += [r for r in order if r not in picks][: max(0, n - len(picks))]
    return sorted(picks, key=lambda r: r.index)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))
