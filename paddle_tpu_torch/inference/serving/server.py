"""Asyncio serving front end — counterpart of
``paddle_tpu/inference/serving/server.py``: one event loop, many
clients, one supervised engine thread.

* **Thread-safe submission bridge.** Engine calls stay on ONE dedicated
  engine thread (the pump): clients post submit/cancel commands onto a
  thread-safe queue the pump consumes between iterations, and receive
  token/finish events on per-client ``asyncio.Queue``\\ s fed via
  ``loop.call_soon_threadsafe`` — the event loop multiplexes any number
  of clients without ever touching the device. The pump makes the
  backend's CUDA device current on its own thread before its first step
  (the current device is per thread); the loop thread reads only host
  state (``/metrics`` serves the snapshots, which touch no device
  tensor).

* **SSE-style token events.** A stream yields dict events — ``start``,
  ``token`` (one per generated token), ``finish`` (the serving record:
  state/TTFT/TPOT/prefix-hit/preemption counters), ``disconnect`` — and
  the TCP transport encodes them as ``text/event-stream`` frames. The
  in-process transport (:meth:`ServingServer.handle` /
  :meth:`agenerate`) runs the same handler without sockets.

* **Per-client backpressure.** Each client buffer is bounded
  (``FLAGS_serving_client_queue``); a consumer that falls that far behind
  is a SLOW CONSUMER — it is disconnected and its request cancelled
  through ``cancel()``, freeing KV immediately. Closing/abandoning a
  stream cancels the same way, so a vanished SSE client can never pin
  the pool.

* **Supervision + drain + ops endpoints.** The pump drives an
  :class:`~.supervisor.EngineSupervisor` or a
  :class:`~.router.ServingRouter` — crash barrier, restart budget,
  resubmission — and reacts to its drain flag (SIGTERM via
  :meth:`install_signal_handlers`, or :meth:`close`): admissions get the
  structured 503 + ``retry_after_s``, in-flight work finishes within the
  deadline, the remainder is cancelled. ``/healthz`` (liveness),
  ``/readyz`` (accepting and the restart budget intact) and ``/metrics``
  (the full health snapshot + TPOT per tenant + the autoscale signal)
  serve the backend's payload.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import json
import queue as _tqueue
import signal as _signal
import threading
import time
from typing import Any, AsyncIterator, Dict, Optional, Tuple

import torch

from ...flags import flag
from .scheduler import ServingQueueFull
from .supervisor import EngineSupervisor, ServingUnavailable

__all__ = ["ServingServer", "ClientStream", "sse_encode"]


def sse_encode(event: Dict[str, Any]) -> bytes:
    """One Server-Sent-Events frame: ``event:`` carries the type,
    ``data:`` the JSON payload."""
    return (f"event: {event.get('type', 'message')}\n"
            f"data: {json.dumps(event)}\n\n").encode()


class ClientStream:
    """One client's event pipe. The pump thread feeds ``q`` through the
    loop; the consumer iterates :meth:`events`. ``dropped`` flips when
    the bounded buffer overflows (slow consumer) — the server cancels
    the request the moment that happens, and the consumer sees a
    terminal ``disconnect`` event after draining what was delivered."""

    def __init__(self, maxsize: int):
        self.q: asyncio.Queue = asyncio.Queue(maxsize=max(1, maxsize))
        self.srid: Optional[int] = None
        self.dropped = False
        self.closed = False
        self.done = False

    async def events(self) -> AsyncIterator[Dict[str, Any]]:
        while True:
            if self.dropped and self.q.empty():
                yield {"type": "disconnect", "reason": "slow_consumer",
                       "rid": self.srid}
                return
            try:
                ev = await asyncio.wait_for(self.q.get(), timeout=0.05)
            except asyncio.TimeoutError:
                if self.done and self.q.empty():
                    return
                continue
            if ev is None:                      # end-of-stream sentinel
                return
            yield ev


class ServingServer:
    """The asyncio front line over one :class:`EngineSupervisor`.

    Lifecycle::

        sup = EngineSupervisor(params, cfg, ServingConfig(...))
        srv = ServingServer(sup)
        async with srv.running():               # starts the engine thread
            async for ev in srv.agenerate(prompt, max_new_tokens=32):
                ...                             # in-process, port-free
        # srv.close() ran: drained, cancelled the rest, joined the pump

    ``await srv.start_tcp(host, port)`` inside ``running()`` additionally
    serves the same handler over HTTP/1.1 + SSE on a real socket.
    """

    def __init__(self, supervisor,
                 client_queue: Optional[int] = None,
                 poll_s: float = 0.02):
        # `supervisor` is an EngineSupervisor OR a ServingRouter — both
        # speak the same submit/cancel/step/pending/drain/health_snapshot
        # contract, so one server front-lines a single replica or a fleet
        self.sup = supervisor
        self.client_queue = int(client_queue if client_queue is not None
                                else flag("FLAGS_serving_client_queue"))
        self._poll_s = float(poll_s)
        self._cmds: _tqueue.Queue = _tqueue.Queue()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._open: Dict[int, ClientStream] = {}    # srid -> live stream
        self._tcp: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        self.drain_report: Optional[Dict[str, Any]] = None
        self.pump_error: Optional[BaseException] = None
        # the CUDA device the pump makes current on its thread (None on
        # the CPU): an index-less "cuda" backend lives on the device that
        # was current where it was built, which is this caller's; a
        # tensor-parallel placement's is its lead device
        dev = getattr(supervisor, "_device", None) or "cuda"
        if isinstance(dev, (list, tuple)):
            dev = dev[0]
        dev = torch.device(dev)
        self._cuda_index: Optional[int] = None
        if dev.type == "cuda":
            self._cuda_index = (dev.index if dev.index is not None
                                else torch.cuda.current_device())

    @classmethod
    def cold_start(cls, journal_dir: str, params, model_config,
                   serving_config=None, gen_config=None,
                   replicas: Optional[int] = None, router_config=None,
                   device=None, **server_kw) -> "ServingServer":
        """Build a server over a crash-recovered backend: a
        :meth:`~.router.ServingRouter.cold_start` fleet when
        ``replicas``/``router_config`` is given, else a single
        :meth:`EngineSupervisor.recover` replica, on ``device`` (the
        card unless ``"cpu"``). Every request the dead process had
        journaled and not finished resumes bit-exactly; its SIGTERM path
        (``install_signal_handlers`` → drain) flushes the journal and
        writes a final snapshot before exit, closing the durability loop
        for the next cold start."""
        if replicas is not None or router_config is not None:
            from .router import ServingRouter
            backend = ServingRouter.cold_start(
                journal_dir, params, model_config, serving_config,
                gen_config, router_config=router_config,
                replicas=replicas, device=device)
        else:
            backend = EngineSupervisor.recover(
                journal_dir, params, model_config, serving_config,
                gen_config, device=device)
        return cls(backend, **server_kw)

    # ---- lifecycle ---------------------------------------------------------

    async def start_pump(self) -> None:
        """Bind to the running loop and start the engine thread."""
        if self._thread is not None:
            return
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="serving-pump")
        self._thread.start()

    @contextlib.asynccontextmanager
    async def running(self, host: Optional[str] = None, port: int = 0):
        await self.start_pump()
        if host is not None:
            await self.start_tcp(host, port)
        try:
            yield self
        finally:
            await self.close()

    def install_signal_handlers(self) -> bool:
        """SIGTERM (the launcher's preemption forward) requests a
        graceful drain on the pump thread. Uses the loop's handler when
        possible; returns False when signals can't be installed here."""
        try:
            self._loop.add_signal_handler(_signal.SIGTERM,
                                          self.sup.request_drain)
            return True
        except (NotImplementedError, RuntimeError, ValueError):
            return self.sup.install_signal_handler() is not None

    async def close(self, deadline_s: Optional[float] = None
                    ) -> Optional[Dict[str, Any]]:
        """Graceful shutdown: stop the TCP listener, drain the supervisor
        (admissions 503, in-flight finished within the deadline, rest
        cancelled), then stop and join the pump thread. Returns the drain
        report."""
        if self._tcp is not None:
            self._tcp.close()
            with contextlib.suppress(Exception):
                await self._tcp.wait_closed()
            self._tcp = None
        if self._thread is None:
            return self.drain_report
        if self.drain_report is None:
            fut: concurrent.futures.Future = concurrent.futures.Future()
            self._cmds.put(("drain", deadline_s, None, fut))
            self.drain_report = await asyncio.wrap_future(fut)
        self._stop.set()
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join, 10.0)
        self._thread = None
        return self.drain_report

    # ---- the engine thread -------------------------------------------------

    def _pump(self) -> None:
        """The single engine thread: consume commands, drive the
        supervised step loop, route events. Every engine/scheduler call
        in the process happens here (or under the engine lock), which is
        what makes the asyncio side safe. One iteration failing must not
        kill the thread — a dead pump strands every client and hangs
        close() — so the body runs under its own barrier; the last error
        is kept for /healthz."""
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while not self._stop.is_set():
            try:
                self._pump_once()
            except Exception as e:                # noqa: BLE001 — barrier
                self.pump_error = e
                time.sleep(self._poll_s)

    def _pump_once(self) -> None:
        busy = self.sup.pending
        self._run_cmds(block=not busy)
        if self.sup.drain_requested and self.drain_report is None:
            self._drain_now(None)
            return
        # route finishes even when idle: a broken flip or an external
        # cancel must still deliver terminal events to open streams
        self._route_finishes()
        if not self.sup.pending:
            return
        emitted = self.sup.step(self._decode_chunk())
        for srid, toks in emitted.items():
            client = self._open.get(srid)
            if client is None:
                continue
            for t in toks:
                self._deliver(client, {"type": "token", "rid": srid,
                                       "token": int(t)})
        self._route_finishes()

    def _decode_chunk(self) -> int:
        """Streaming-granularity cap per pump iteration: the router
        exposes it directly (one shared ServingConfig), a bare
        supervisor through its engine."""
        chunk = getattr(self.sup, "decode_chunk", None)
        if chunk is not None:
            return int(chunk)
        return int(self.sup.engine.config.decode_chunk)

    def _run_cmds(self, block: bool) -> None:
        try:
            cmd = self._cmds.get(timeout=self._poll_s) if block \
                else self._cmds.get_nowait()
        except _tqueue.Empty:
            return
        while True:
            self._run_cmd(cmd)
            try:
                cmd = self._cmds.get_nowait()
            except _tqueue.Empty:
                return

    def _run_cmd(self, cmd) -> None:
        kind, payload, client, fut = cmd
        if kind == "submit":
            try:
                srid = self.sup.submit(**payload)
                if client is not None:
                    client.srid = srid
                    self._open[srid] = client
                if fut is not None:
                    fut.set_result(srid)
            except Exception as e:                # noqa: BLE001 — to caller
                if fut is not None:
                    fut.set_exception(e)
        elif kind == "cancel":
            ok = self.sup.cancel(payload)
            self._route_finishes()
            if fut is not None:
                fut.set_result(ok)
        elif kind == "drain":
            self._drain_now(payload)
            if fut is not None:
                fut.set_result(self.drain_report)

    def _drain_now(self, deadline_s) -> None:
        if self.drain_report is None:       # SIGTERM and close() can race
            self.drain_report = self.sup.drain(deadline_s)
        self._route_finishes()

    def _route_finishes(self) -> None:
        """Terminal transitions -> finish events + end-of-stream
        sentinels for the affected clients."""
        for srid in list(self._open):
            rec = self.sup._reqs.get(srid)
            if rec is None or not rec.terminal:
                continue
            # default: an abandoning consumer (agenerate's finally, loop
            # thread) can pop the same srid between the snapshot above
            # and here — losing that race must not kill the pump
            client = self._open.pop(srid, None)
            if client is None:
                continue
            fin = dict(rec.finish or {"state": rec.state,
                                      "tokens": len(rec.tokens)})
            fin.update({"type": "finish", "rid": srid})
            self._deliver(client, fin)
            self._deliver(client, None)

    def _deliver(self, client: ClientStream, ev) -> None:
        """Pump thread -> loop: enqueue one event on the client's bounded
        buffer. Overflow = slow consumer: mark dropped and cancel its
        request so abandoned/stalled streams free KV immediately."""
        loop = self._loop

        def _put():
            # a dropped client is DISCONNECTED: no further delivery (the
            # consumer drains what it had and gets the terminal
            # `disconnect` marker), so its later finish/sentinel can't
            # race the drain into looking like a normal end-of-stream
            if client.closed or client.dropped:
                return
            if ev is None:
                client.done = True
                with contextlib.suppress(asyncio.QueueFull):
                    client.q.put_nowait(None)
                return
            try:
                client.q.put_nowait(ev)
            except asyncio.QueueFull:
                client.dropped = True
                if client.srid is not None:
                    self._cmds.put(("cancel", client.srid, None, None))

        loop.call_soon_threadsafe(_put)

    # ---- async client surface (the in-process transport) --------------------

    async def submit(self, **kwargs) -> int:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._cmds.put(("submit", kwargs, None, fut))
        return await asyncio.wrap_future(fut)

    async def cancel(self, srid: int) -> bool:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._cmds.put(("cancel", srid, None, fut))
        return await asyncio.wrap_future(fut)

    async def open_stream(self, prompt, **kwargs
                          ) -> Tuple[int, ClientStream]:
        """Submit + attach a client pipe; returns ``(srid, stream)``.
        Raises what submit raises (queue full / draining / bad
        request)."""
        client = ClientStream(self.client_queue)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._cmds.put(("submit", {"prompt": prompt, **kwargs}, client,
                        fut))
        srid = await asyncio.wrap_future(fut)
        return srid, client

    async def agenerate(self, prompt, **kwargs
                        ) -> AsyncIterator[Dict[str, Any]]:
        """The in-process streaming client: yields ``start`` / ``token``
        / ``finish`` (/ ``disconnect``) events. Abandoning the iterator
        (``aclose()``, ``break`` + GC, a vanished consumer) cancels the
        request — its KV blocks return to the pool immediately."""
        srid, client = await self.open_stream(prompt, **kwargs)
        finished = False
        try:
            yield {"type": "start", "rid": srid}
            async for ev in client.events():
                if ev.get("type") in ("finish", "disconnect"):
                    finished = True
                yield ev
        finally:
            client.closed = True
            self._open.pop(srid, None)
            if not finished:
                self._cmds.put(("cancel", srid, None, None))

    # ---- the one request handler (both transports) ---------------------------

    async def handle(self, method: str, path: str,
                     body: Optional[Dict[str, Any]] = None
                     ) -> Tuple[int, Any]:
        """Route one request. Returns ``(status, payload)`` where payload
        is a JSON-serializable dict, or ``("sse", async_iterator)`` for
        the streaming endpoint. The in-process transport calls this
        directly (no sockets); the TCP transport serializes
        it."""
        if method == "GET" and path == "/healthz":
            alive = self._thread is not None and self._thread.is_alive()
            snap = self.sup.health_snapshot()
            ok = bool(alive and snap["ok"])
            return (200 if ok else 503), {
                "ok": ok, "pump_alive": alive,
                "pump_error": (str(self.pump_error)
                               if self.pump_error else None),
                "watchdog": snap["watchdog"]}
        if method == "GET" and path == "/readyz":
            snap = self.sup.health_snapshot()
            sup = snap["supervisor"]
            ready = bool(snap["accepting"])
            return (200 if ready else 503), {
                "ready": ready, "accepting": snap["accepting"],
                "draining": sup["draining"], "broken": sup["broken"],
                "restarts": sup["restarts"],
                "restart_budget": sup["restart_budget"],
                "retry_after_s": snap["retry_after_s"]}
        if method == "GET" and path == "/metrics":
            return 200, self.sup.health_snapshot()
        if method == "POST" and path == "/generate":
            body = dict(body or {})
            if "prompt" not in body:
                return 400, {"error": "missing 'prompt'"}
            try:
                gen = self.agenerate(body.pop("prompt"), **body)
                first = await gen.__anext__()       # surfaces submit errors
            except ServingUnavailable as e:
                return 503, {"error": str(e), "reason": e.reason,
                             "retry_after_s": e.retry_after_s}
            except ServingQueueFull as e:
                return 429, {"error": str(e), "reason": "shed",
                             "queue_depth": e.queue_depth,
                             "live_slots": e.live_slots,
                             "retry_after_s": e.retry_after_s}
            except (TypeError, ValueError) as e:
                return 400, {"error": str(e)}

            async def _stream():
                try:
                    yield first
                    async for ev in gen:
                        yield ev
                finally:
                    await gen.aclose()

            return 200, ("sse", _stream())
        return 404, {"error": f"no route {method} {path}"}

    # ---- TCP transport (HTTP/1.1 + SSE) --------------------------------------

    async def start_tcp(self, host: str = "127.0.0.1",
                        port: int = 0) -> int:
        """Serve :meth:`handle` over a real socket (HTTP/1.1 + SSE);
        returns the bound port."""
        self._tcp = await asyncio.start_server(self._conn, host, port)
        self.port = self._tcp.sockets[0].getsockname()[1]
        return self.port

    async def _conn(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            try:
                method, path, _ = line.decode().split(None, 2)
            except ValueError:
                return
            clen = 0
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                name, _, val = h.decode().partition(":")
                if name.strip().lower() == "content-length":
                    clen = int(val.strip() or 0)
            body = None
            if clen:
                raw = await reader.readexactly(clen)
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError:
                    body = None
            status, payload = await self.handle(method.upper(), path, body)
            reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                      429: "Too Many Requests",
                      503: "Service Unavailable"}.get(status, "OK")
            if isinstance(payload, tuple) and payload[0] == "sse":
                writer.write((f"HTTP/1.1 {status} {reason}\r\n"
                              "Content-Type: text/event-stream\r\n"
                              "Cache-Control: no-cache\r\n"
                              "Connection: close\r\n\r\n").encode())
                gen = payload[1]
                try:
                    async for ev in gen:
                        writer.write(sse_encode(ev))
                        await writer.drain()
                except (ConnectionResetError, BrokenPipeError):
                    pass                # client vanished mid-stream
                finally:
                    await gen.aclose()  # -> cancel if not finished
            else:
                data = json.dumps(payload).encode()
                extra = ""
                ra = isinstance(payload, dict) and \
                    payload.get("retry_after_s")
                if status in (429, 503) and ra:
                    extra = f"Retry-After: {max(1, int(round(ra)))}\r\n"
                writer.write((f"HTTP/1.1 {status} {reason}\r\n"
                              "Content-Type: application/json\r\n"
                              f"Content-Length: {len(data)}\r\n{extra}"
                              "Connection: close\r\n\r\n").encode())
                writer.write(data)
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()


def serve_requests(server: ServingServer, prompts,
                   **kwargs) -> Dict[str, Any]:
    """Synchronous convenience: serve a batch of prompts through the
    in-process transport on a private event loop. Returns
    ``{"outputs": [token lists in submission order], "elapsed_s": serve
    wall time (drain excluded), "drain_report": close()'s report}``."""

    async def _run():
        outs = [None] * len(prompts)
        async with server.running():
            t0 = time.time()

            async def one(i):
                toks = []
                async for ev in server.agenerate(prompts[i], **kwargs):
                    if ev["type"] == "token":
                        toks.append(ev["token"])
                outs[i] = toks

            await asyncio.gather(*(one(i) for i in range(len(prompts))))
            elapsed = time.time() - t0
        return outs, elapsed

    outs, elapsed = asyncio.run(_run())
    return {"outputs": outs, "elapsed_s": elapsed,
            "drain_report": server.drain_report}
