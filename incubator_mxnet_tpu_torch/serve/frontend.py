"""Client-facing HTTP/SSE serving front end (docs/SERVING.md "Client
protocol").

The port of ``incubator_mxnet_tpu/serve/frontend.py``: a stdlib-only
asyncio HTTP/1.1 server in front of an ``InferenceEngine`` or a fleet
``Router`` (anything with ``submit`` / ``cancel`` / ``step`` /
``health_snapshot`` / ``flight``), speaking the serving contract of
structured terminal Outcomes, ``retry_after_s`` backpressure hints, SLO
tiers, cancellation from any state and per-token timestamps:

  - ``POST /v1/completions`` — JSON in, Server-Sent Events out
    (``stream: false`` for a single JSON response). Tokens stream AS
    THEY LAND: the stepper pumps each scheduler step's emissions into
    per-request queues (the per-token delivery ``Request.token_stamps``
    records), so TTFT is one prefill away, not one completion away.
  - Every terminal ``Outcome`` maps to a documented HTTP status
    (``OUTCOME_HTTP_STATUS`` — golden-tested: distinct statuses per
    failure class), and every retryable outcome carries its
    ``retry_after_s`` hint as a real ``Retry-After`` header (integer
    ceiling; the exact float rides the JSON body). A stream that
    already sent its 200 reports the terminal in the final SSE event
    instead.
  - A client DISCONNECT becomes ``backend.cancel`` — the engine
    reclaims the slot and pages mid-decode, exactly the engine's
    cancellation contract, so walked-away work stops burning
    capacity. A SLOW READER is bounded the same way: when
    ``writer.drain()`` cannot flush within ``drain_timeout_s`` (the
    transport's write buffer is capped at ``write_buffer``), the
    request is cancelled rather than letting one stalled socket pin a
    slot forever.
  - ``GET /metrics`` — the backend's Prometheus snapshot
    (serve/metrics.py) plus the front end's own http counters;
    ``GET /healthz`` — a cheap liveness/queue summary.
  - The client edge lands on the flight recorder (serve/events.py):
    the front end emits SUBMIT / ADMIT (stream opened) / TERMINAL
    (with ``http_status`` and the disconnect cause) on its own
    ``frontend`` component lane of the BACKEND's recorder, so a
    ``tools/trace_export.py`` Perfetto timeline shows request
    residency from the socket inward.

On the card, the stepper's thread is where the backend's CUDA graphs
are captured and replayed (PyTorch's current stream is per thread). A
capture fails if another thread makes a CUDA call while it runs, so
everything the HTTP side calls on the backend (``submit``, ``cancel``,
``health_snapshot``) is host-only, and all of it runs on the same loop
thread besides.

Threading model — one loop, zero shared mutable state with the
scheduler: ``start()`` spawns ONE background thread running ONE
asyncio event loop that hosts BOTH the HTTP server and the stepper
task calling ``backend.step()``. Handlers and the stepper interleave
only at awaits, and ``step()`` is synchronous — so ``submit``/
``cancel``/stream bookkeeping can never race a scheduler step, with
no locks on the data plane. The class lock guards only the
start/stop handshake and the stats counters the main thread may read
(the CheckpointManager lock contract, mxlint ``lock-discipline``).

Stop sequences and streaming: the engine truncates a matched stop
sequence out of the output, so the front end holds back the last
``max_stop_len - 1`` tokens of a stop-armed stream until they are
disambiguated — a client never sees a token the match would retract
(the standard streaming-API semantic).
"""

from __future__ import annotations

import asyncio
import json
import math
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..base import MXNetError
from .engine import Request
from .events import EventType
from .metrics import render_frontend_metrics, render_metrics
from .outcomes import Outcome
from .sampling import SamplingParams, choice_grammar
from .slo import Tier

__all__ = ["ServeFrontend", "OUTCOME_HTTP_STATUS", "outcome_status",
           "parse_request_payload", "http_request",
           "stream_completion"]


# The client-protocol half of docs/RESILIENCE.md's outcome taxonomy:
# one documented, golden-tested status per outcome. Success outcomes
# share 200; every failure outcome gets a DISTINCT status so a client
# (or a dashboard bucketing by status) can tell the classes apart
# without parsing detail strings. Retryable outcomes additionally
# carry a Retry-After header.
OUTCOME_HTTP_STATUS = {
    Outcome.EOS: 200,
    Outcome.MAX_TOKENS: 200,
    Outcome.STOP: 200,
    Outcome.SHED: 429,               # back off, retry (Retry-After)
    Outcome.DEADLINE_EXPIRED: 504,   # ran out of the client's time
    Outcome.FAILED_REPLICA: 502,     # the fleet lost its replicas
    Outcome.PREEMPTED: 503,          # displaced by higher-tier work
    Outcome.FAILED_NONFINITE: 500,   # server-side numeric fault
    Outcome.FAILED_UNSERVABLE: 422,  # this request can never be served
    Outcome.CANCELLED: 499,          # client closed the connection
}

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            422: "Unprocessable Entity", 429: "Too Many Requests",
            499: "Client Closed Request", 500: "Internal Server Error",
            502: "Bad Gateway", 503: "Service Unavailable",
            504: "Gateway Timeout"}


def outcome_status(outcome: Outcome) -> int:
    return OUTCOME_HTTP_STATUS[outcome]


def parse_request_payload(payload: dict,
                          vocab: int) -> Tuple[Request, bool]:
    """JSON request body -> (``Request``, stream?). The one schema
    parser (the server, the bench and the tests all route through it).
    Raises ``MXNetError``/``ValueError`` on malformed input — the
    handler maps those to 400.

    Schema (docs/SERVING.md "Client protocol"): ``prompt`` (list of
    token ids, required), ``max_new_tokens``, ``temperature``,
    ``eos_id``, ``deadline_s``, ``seed``, ``tier`` (LATENCY |
    STANDARD | BATCH), ``stream`` (default true), and the sampling
    menu — ``top_k``, ``top_p``, ``repetition_penalty``,
    ``presence_penalty``, ``logit_bias`` ({token: bias}),
    ``stop`` (list of token-id sequences), ``grammar``
    ({"type": "choice", "sequences": [[...], ...]} — richer grammars
    plug in through the Python API's ``TokenGrammar``)."""
    if not isinstance(payload, dict):
        raise MXNetError("request body must be a JSON object")
    known = {"prompt", "max_new_tokens", "temperature", "eos_id",
             "deadline_s", "seed", "tier", "stream", "top_k", "top_p",
             "repetition_penalty", "presence_penalty", "logit_bias",
             "stop", "grammar"}
    unknown = set(payload) - known
    if unknown:
        raise MXNetError(f"unknown request fields {sorted(unknown)}")
    prompt = payload.get("prompt")
    if not isinstance(prompt, (list, tuple)) or not prompt or \
            not all(isinstance(t, int) and 0 <= t < vocab
                    for t in prompt):
        raise MXNetError(f"prompt must be a non-empty list of token "
                         f"ids in [0, {vocab})")
    stream = bool(payload.get("stream", True))
    tier = payload.get("tier", Tier.STANDARD.value)
    if isinstance(tier, str):
        try:
            tier = Tier(tier)
        except ValueError:
            raise MXNetError(f"unknown tier {tier!r}")
    sampling = None
    menu = {"top_k", "top_p", "repetition_penalty", "presence_penalty",
            "logit_bias", "stop", "grammar"}
    if menu & set(payload):
        bias = payload.get("logit_bias")
        if bias is not None:
            if not isinstance(bias, dict):
                raise MXNetError("logit_bias must be an object "
                                 "{token_id: bias}")
            bias = {int(t): float(b) for t, b in bias.items()}
        stop = payload.get("stop") or ()
        if stop and (not isinstance(stop, (list, tuple)) or
                     not all(isinstance(s, (list, tuple)) and s and
                             all(isinstance(t, int) for t in s)
                             for s in stop)):
            raise MXNetError("stop must be a list of non-empty "
                             "token-id sequences")
        grammar = None
        gspec = payload.get("grammar")
        if gspec is not None:
            if not isinstance(gspec, dict) or \
                    gspec.get("type") != "choice" or \
                    not gspec.get("sequences"):
                raise MXNetError(
                    'grammar must be {"type": "choice", "sequences": '
                    '[[token, ...], ...]} (richer grammars: the '
                    'Python API takes any TokenGrammar)')
            grammar = choice_grammar(gspec["sequences"], vocab)
        sampling = SamplingParams(
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            repetition_penalty=float(
                payload.get("repetition_penalty", 1.0)),
            presence_penalty=float(
                payload.get("presence_penalty", 0.0)),
            logit_bias=bias,
            stop_sequences=tuple(tuple(s) for s in stop),
            grammar=grammar)
    seed = payload.get("seed")
    deadline = payload.get("deadline_s")
    req = Request(
        prompt_ids=list(prompt),
        max_new_tokens=int(payload.get("max_new_tokens", 32)),
        temperature=float(payload.get("temperature", 0.0)),
        eos_id=int(payload.get("eos_id", -1)),
        deadline_s=float(deadline) if deadline is not None else None,
        seed=int(seed) if seed is not None else None,
        tier=tier, sampling=sampling)
    return req, stream


class _EngineShape:
    """Everything the front end needs that the two backend kinds spell
    differently, concentrated in one seam per kind: busy/progress/
    stall-giveup (the stepper loop), the model vocab, live-token reads
    and the health extras. ``ServeFrontend`` itself never duck-types
    the backend — a third backend kind means a third shape class, and
    a backend-internal rename breaks exactly one method here instead
    of scattering AttributeErrors across the server."""

    def __init__(self, backend):
        self.b = backend

    def vocab_size(self) -> int:
        return self.b.model.vocab_size

    def busy(self) -> bool:
        return bool(self.b._queue or self.b.active_count)

    def made_progress(self, n: int) -> bool:
        return n > 0 or self.b.active_count > 0

    def stall_limit(self) -> int:
        return self.b.stall_steps

    def give_up_stalled(self, stall: int):
        self.b._fail_starved_head(stall)

    def live_tokens(self, req: Request) -> List[int]:
        return req.token_ids

    def health_extra(self, info: dict):
        info["active_slots"] = self.b.active_count


class _RouterShape(_EngineShape):
    def vocab_size(self) -> int:
        # a Router's replicas serve one model (each its own copy)
        return self.b.replicas[0].engine.model.vocab_size

    def busy(self) -> bool:
        return bool(self.b._queue or self.b._inflight)

    def made_progress(self, n: int) -> bool:
        return n > 0

    def stall_limit(self) -> int:
        return self.b._stall_limit()

    def give_up_stalled(self, stall: int):
        self.b._fail_starved(self.b._stall_limit())

    def live_tokens(self, req: Request) -> List[int]:
        return self.b.live_tokens(req)

    def health_extra(self, info: dict):
        info["inflight"] = len(self.b._inflight)
        info["replicas"] = {
            s.value: sum(1 for r in self.b.replicas if r.state is s)
            for s in type(self.b.replicas[0].state)}


class _Stream:
    """One live SSE/blocking response: the request, the per-request
    delivery queue the stepper pumps, and the holdback window for
    stop-armed streams."""

    __slots__ = ("request", "queue", "delivered", "holdback",
                 "disconnect", "lane", "t_open")

    def __init__(self, request: Request, lane: int):
        self.request = request
        self.queue: asyncio.Queue = asyncio.Queue()
        self.delivered = 0
        sp = request.sampling
        self.holdback = max(0, sp.max_stop_len - 1) \
            if sp is not None and sp.stop_sequences else 0
        self.disconnect: Optional[str] = None
        self.lane = lane
        self.t_open = time.perf_counter()


class ServeFrontend:
    """The HTTP/SSE front end over one serving backend (an
    ``InferenceEngine`` or a ``Router``). ``start()`` binds
    ``host:port`` (port 0 = ephemeral) and returns once accepting;
    ``stop()`` shuts the server and the stepper down. Use as a context
    manager in tests/benches.

    ``after_step(backend)`` is the chaos/bench hook bracket — called
    after every scheduler step the stepper runs (a chaos harness's
    per-step ``audit_pages`` point)."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 poll_sleep: float = 1e-3, drain_timeout_s: float = 5.0,
                 header_timeout_s: float = 30.0,
                 write_buffer: int = 65536, sndbuf: Optional[int] = None,
                 sse_pad_bytes: int = 0,
                 max_body_bytes: int = 1 << 20, after_step=None,
                 keep_finished: int = 4096):
        self.backend = backend
        self.flight = backend.flight
        self._component = "frontend"
        self.host = host
        self.port = int(port)
        self.poll_sleep = float(poll_sleep)
        self.drain_timeout_s = float(drain_timeout_s)
        # the read-side twin of drain_timeout_s: a client that sends a
        # partial request line / headers / body may not pin a
        # connection task forever (slowloris)
        self.header_timeout_s = float(header_timeout_s)
        self.write_buffer = int(write_buffer)
        self.sndbuf = sndbuf
        # optional per-event padding: models richer token payloads
        # (logprobs, byte text) so the slow-reader backpressure bound
        # is testable without gigantic generations — the Linux kernel
        # will not shrink a socket send buffer below ~tens of KB, so
        # tiny events alone cannot fill it deterministically
        self.sse_pad_bytes = int(sse_pad_bytes)
        self.max_body_bytes = int(max_body_bytes)
        self.after_step = after_step
        # the one place that knows which backend kind this is
        self._shape = _RouterShape(backend) \
            if hasattr(backend, "replicas") else _EngineShape(backend)
        # the model vocab bounds prompt ids and grammar specs
        self._vocab = self._shape.vocab_size()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._loop = None
        self._stop_ev = None
        self._bound_port: Optional[int] = None
        self._start_error: Optional[BaseException] = None
        self._ready = threading.Event()
        self._streams: Dict[int, _Stream] = {}
        self._conn_tasks = set()
        self._lane_counter = 0
        self._backend_error: Optional[str] = None
        # finished Request objects, newest last — the test/chaos
        # harness's exactly-one-terminal oracle (bounded)
        self.finished: deque = deque(maxlen=int(keep_finished))
        self.stats = {"http_requests": 0, "http_responses": {},
                      "disconnects": 0, "slow_reader_cancels": 0,
                      "sse_tokens": 0}

    # ------------------------------------------------------------- #
    # lifecycle (main thread)
    # ------------------------------------------------------------- #

    def start(self) -> "ServeFrontend":
        if self._thread is not None:
            raise MXNetError("frontend already started")
        self._thread = threading.Thread(target=self._thread_main,
                                        name="mxtpu-frontend",
                                        daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=60):
            raise MXNetError("frontend did not start within 60s")
        with self._lock:
            err = self._start_error
        if err is not None:
            self._thread.join(timeout=5)
            self._thread = None
            raise MXNetError(f"frontend failed to start: {err}")
        return self

    def stop(self):
        if self._thread is None:
            return
        with self._lock:
            loop, ev = self._loop, self._stop_ev
        if loop is not None and ev is not None:
            try:
                loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass                     # loop already gone
        self._thread.join(timeout=60)
        self._thread = None

    def __enter__(self) -> "ServeFrontend":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def bound_port(self) -> int:
        with self._lock:
            if self._bound_port is None:
                raise MXNetError("frontend not started")
            return self._bound_port

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.bound_port}"

    def stats_snapshot(self) -> dict:
        with self._lock:
            snap = dict(self.stats)
            snap["http_responses"] = dict(self.stats["http_responses"])
            snap["open_streams"] = len(self._streams)
        return snap

    # ------------------------------------------------------------- #
    # the loop thread
    # ------------------------------------------------------------- #

    def _thread_main(self):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._amain())
        except BaseException as e:       # startup/shutdown failure
            with self._lock:
                self._start_error = e
        finally:
            self._ready.set()            # unblock start() either way
            try:
                loop.close()
            except Exception:
                pass

    async def _amain(self):
        stop_ev = asyncio.Event()
        with self._lock:
            self._stop_ev = stop_ev
            self._loop = asyncio.get_running_loop()
        server = await asyncio.start_server(self._handle, self.host,
                                            self.port)
        with self._lock:
            self._bound_port = server.sockets[0].getsockname()[1]
        self._ready.set()
        stepper = asyncio.ensure_future(self._drive(stop_ev))
        await stop_ev.wait()
        server.close()
        await server.wait_closed()
        with self._lock:
            conns = list(self._conn_tasks)
        for t in conns:
            t.cancel()
        await asyncio.gather(stepper, *conns, return_exceptions=True)

    # -- stepper: the scheduler loop ------------------------------- #

    def _backend_busy(self) -> bool:
        return self._shape.busy()

    def _made_progress(self, n: int) -> bool:
        return self._shape.made_progress(n)

    def _give_up_stalled(self, stall: int):
        """Bounded starved-head give-up — the SAME audited outcome
        path ``run()`` uses (engine ``_fail_starved_head`` / router
        ``_fail_starved``), so a front-ended engine wedges exactly as
        rarely and fails exactly as loudly as a driven one."""
        self._shape.give_up_stalled(stall)

    def _stall_limit(self) -> int:
        return self._shape.stall_limit()

    async def _drive(self, stop_ev: asyncio.Event):
        stall = 0
        while not stop_ev.is_set():
            if not self._backend_busy():
                stall = 0
                # still pump: a cancel (or a submit-time terminal
                # recorded by another handler) can land while the
                # scheduler is idle, and its stream must retire
                self._pump()
                await asyncio.sleep(self.poll_sleep)
                continue
            try:
                n = self.backend.step()
            except Exception as e:       # the backend died under us
                with self._lock:
                    self._backend_error = f"{type(e).__name__}: {e}"
                self._fail_open_streams(self._backend_error)
                await asyncio.sleep(self.poll_sleep)
                continue
            self._pump()
            if self.after_step is not None:
                self.after_step(self.backend)
            if self._made_progress(n):
                stall = 0
                # yield so handlers can write between steps — this is
                # what makes tokens STREAM instead of batch up
                await asyncio.sleep(0)
            else:
                stall += 1
                if stall > self._stall_limit():
                    self._give_up_stalled(stall)
                    self._pump()
                    stall = 0
                await asyncio.sleep(self.poll_sleep)

    def _live_tokens(self, req: Request) -> List[int]:
        return self._shape.live_tokens(req)

    def _pump(self):
        """Push newly-landed tokens into each open stream's queue and
        retire streams whose request went terminal. Runs on the loop
        thread between scheduler steps — never concurrent with
        ``step()``."""
        with self._lock:
            streams = list(self._streams.values())
        retired = []
        for st in streams:
            req = st.request
            if req.outcome is None:
                toks = self._live_tokens(req)
                limit = len(toks) - st.holdback
                while st.delivered < limit:
                    st.queue.put_nowait(("token",
                                         int(toks[st.delivered])))
                    st.delivered += 1
            else:
                toks = req.token_ids     # final, post-truncation
                while st.delivered < len(toks):
                    st.queue.put_nowait(("token",
                                         int(toks[st.delivered])))
                    st.delivered += 1
                st.queue.put_nowait(("terminal", None))
                retired.append(st)
        if not retired:
            return
        with self._lock:
            for st in retired:
                self._streams.pop(st.request.request_id, None)
                self.finished.append(st.request)
                status = OUTCOME_HTTP_STATUS[st.request.outcome]
                resp = self.stats["http_responses"]
                resp[str(status)] = resp.get(str(status), 0) + 1
        for st in retired:
            req = st.request
            self.flight.emit(
                self._component, EventType.TERMINAL,
                request_id=req.request_id, outcome=req.outcome.value,
                http_status=OUTCOME_HTTP_STATUS[req.outcome],
                tier=req.tier.value, cause=st.disconnect or "",
                tokens=len(req.token_ids))

    def _fail_open_streams(self, detail: str):
        """The stepper hit a backend exception (single-engine death —
        a Router absorbs replica deaths itself): close every open
        stream with an error event so no client hangs forever."""
        with self._lock:
            streams = list(self._streams.values())
            self._streams.clear()
        for st in streams:
            st.queue.put_nowait(("error", detail))

    # -- HTTP plumbing --------------------------------------------- #

    async def _handle(self, reader, writer):
        task = asyncio.current_task()
        with self._lock:
            self._conn_tasks.add(task)
        try:
            if self.sndbuf:
                sock = writer.get_extra_info("socket")
                if sock is not None:
                    sock.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_SNDBUF, int(self.sndbuf))
            parsed = await asyncio.wait_for(self._read_http(reader),
                                            self.header_timeout_s)
            if parsed is not None:
                await self._route(parsed, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, OSError):
            pass                         # connection-level garbage
        finally:
            with self._lock:
                self._conn_tasks.discard(task)
            try:
                writer.close()
            except Exception:
                pass

    async def _read_http(self, reader):
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _ = line.decode("latin1").split(None, 2)
        except ValueError:
            return None
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if b":" in h:
                k, v = h.decode("latin1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
        try:
            n = int(headers.get("content-length", "0") or 0)
        except ValueError:
            n = -1
        if n < 0:                        # malformed Content-Length
            return method.upper(), path, headers, b"", 400
        if n > self.max_body_bytes:
            return method.upper(), path, headers, b"", 413
        body = await reader.readexactly(n) if n else b""
        return method.upper(), path, headers, body, None

    async def _route(self, parsed, reader, writer):
        method, path, _headers, body, err = parsed
        path = path.split("?", 1)[0]
        # http_requests counts every API request — including the ones
        # a 400/404/405/413 turns away before a Request exists — so
        # sum(http_responses) == http_requests holds under malformed
        # traffic too (each counted request is answered exactly once).
        # /healthz and /metrics scrapes are counted in neither (but a
        # read-level reject on those paths IS answered+counted).
        if err is not None or path not in ("/healthz", "/metrics"):
            with self._lock:
                self.stats["http_requests"] += 1
        if err == 400:                   # malformed Content-Length
            await self._respond_json(writer, 400, {
                "error": "invalid Content-Length"})
            return
        if err == 413:
            await self._respond_json(writer, 413, {
                "error": f"body over {self.max_body_bytes} bytes"})
            return
        if path == "/healthz":
            await self._healthz(writer)
        elif path == "/metrics":
            await self._metrics(writer)
        elif path == "/v1/completions":
            if method != "POST":
                await self._respond_json(writer, 405, {
                    "error": "POST required"})
                return
            await self._completions(body, reader, writer)
        else:
            await self._respond_json(writer, 404, {
                "error": f"no route {path}"})

    async def _respond_json(self, writer, status: int, obj: dict,
                            retry_after: Optional[float] = None,
                            count: bool = True):
        """``count=False`` when the response reports a RETIRED stream's
        terminal: ``_pump`` already tallied that status at retirement,
        and counting here too would double it (sum(http_responses)
        must equal the requests that got a response, exactly once
        each). 200s are always stream-backed, so they are never
        counted here."""
        body = (json.dumps(obj) + "\n").encode()
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, '')}".rstrip(),
                "Content-Type: application/json",
                f"Content-Length: {len(body)}",
                "Connection: close"]
        if retry_after is not None:
            head.append(f"Retry-After: {max(1, math.ceil(retry_after))}")
        # tally BEFORE the write: a client that has read the response
        # must see it in stats_snapshot (no post-drain lag window)
        if count and status not in (200,):
            with self._lock:
                resp = self.stats["http_responses"]
                resp[str(status)] = resp.get(str(status), 0) + 1
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()

    async def _healthz(self, writer):
        b = self.backend
        with self._lock:
            err = self._backend_error
            open_streams = len(self._streams)
        info = {"status": "ok" if err is None else "failed",
                "open_streams": open_streams,
                "queue_depth": len(b._queue)}
        if err is not None:
            info["error"] = err
        self._shape.health_extra(info)
        body = (json.dumps(info) + "\n").encode()
        status = 200 if info["status"] == "ok" else 500
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n").encode()
        writer.write(head + body)
        await writer.drain()

    async def _metrics(self, writer):
        text = render_metrics(self.backend.health_snapshot()) + \
            render_frontend_metrics(self.stats_snapshot())
        body = text.encode()
        head = (f"HTTP/1.1 200 OK\r\n"
                f"Content-Type: text/plain; version=0.0.4\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n").encode()
        writer.write(head + body)
        await writer.drain()

    # -- the completion endpoint ----------------------------------- #

    def _result_body(self, req: Request) -> dict:
        status = OUTCOME_HTTP_STATUS[req.outcome]
        body = {"done": True, "request_id": req.request_id,
                "outcome": req.outcome.value, "status": status,
                "tokens": [int(t) for t in req.token_ids],
                "n_tokens": len(req.token_ids),
                "tier": req.tier.value}
        if req.detail:
            body["detail"] = req.detail
        if req.retry_after_s is not None:
            body["retry_after_s"] = req.retry_after_s
        return body

    async def _completions(self, body: bytes, reader, writer):
        try:
            payload = json.loads(body.decode("utf-8") or "null")
            request, stream = parse_request_payload(payload,
                                                    self._vocab)
        except (MXNetError, ValueError, KeyError, TypeError) as e:
            await self._respond_json(writer, 400, {"error": str(e)})
            return
        with self._lock:
            err = self._backend_error
            lane = self._lane_counter
            self._lane_counter += 1
        if err is not None:
            await self._respond_json(writer, 500, {
                "error": f"serving backend failed: {err}"})
            return
        self.flight.emit(self._component, EventType.SUBMIT,
                         request_id=request.request_id,
                         tier=request.tier.value, stream=bool(stream),
                         path="/v1/completions")
        if not self.backend.submit(request):
            # refused at admission — already terminal (SHED /
            # FAILED_* with detail + retry hint); the status line IS
            # the outcome mapping, Retry-After included
            status = OUTCOME_HTTP_STATUS[request.outcome]
            self.flight.emit(self._component, EventType.TERMINAL,
                             request_id=request.request_id,
                             outcome=request.outcome.value,
                             http_status=status,
                             tier=request.tier.value,
                             cause="refused at admission", tokens=0)
            with self._lock:
                self.finished.append(request)
            await self._respond_json(writer, status,
                                     self._result_body(request),
                                     retry_after=request.retry_after_s)
            return
        st = _Stream(request, lane % 16)
        with self._lock:
            self._streams[request.request_id] = st
        self.flight.emit(self._component, EventType.ADMIT,
                         request_id=request.request_id,
                         tier=request.tier.value, slot=st.lane)
        if stream:
            await self._stream_sse(st, reader, writer)
        else:
            await self._blocking_response(st, reader, writer)

    def _client_gone(self, st: _Stream, cause: str,
                     slow: bool = False):
        with self._lock:
            self.stats["disconnects"] += 1
            if slow:
                self.stats["slow_reader_cancels"] += 1
        st.disconnect = cause
        # same loop thread as the stepper — can never race a step();
        # False (already terminal) just means the completion won
        self.backend.cancel(st.request, detail=cause)

    async def _wait_item(self, st: _Stream, watch):
        """Next queue item, racing the connection watch: a closed
        client surfaces as the watch completing (EOF), which raises
        ConnectionResetError here so every caller takes the one
        disconnect path. The watch is checked FIRST: when the token
        queue never runs dry (a backend producing faster than the
        socket drains), ``get`` completes on every wait — preferring
        it would mask the disconnect until the stream ended, exactly
        the capacity leak cancellation exists to stop."""
        get = asyncio.ensure_future(st.queue.get())
        done, _ = await asyncio.wait({get, watch},
                                     return_when=asyncio.FIRST_COMPLETED)
        if watch in done:
            get.cancel()
            raise ConnectionResetError("client closed the connection")
        return get.result()

    async def _stream_sse(self, st: _Stream, reader, writer):
        req = st.request
        head = (f"HTTP/1.1 200 OK\r\n"
                f"Content-Type: text/event-stream\r\n"
                f"Cache-Control: no-cache\r\n"
                f"Connection: close\r\n"
                f"X-Request-Id: {req.request_id}\r\n\r\n").encode()
        writer.write(head)
        writer.transport.set_write_buffer_limits(high=self.write_buffer)
        # a pure-SSE client sends nothing more: any read completion
        # (EOF on close, or stray bytes) means the client is gone
        watch = asyncio.ensure_future(reader.read(1))
        idx = 0
        try:
            await asyncio.wait_for(writer.drain(), self.drain_timeout_s)
            while True:
                kind, val = await self._wait_item(st, watch)
                if kind == "token":
                    ev = {"token": val, "index": idx}
                    if self.sse_pad_bytes:
                        ev["pad"] = "x" * self.sse_pad_bytes
                    data = json.dumps(ev)
                    idx += 1
                    writer.write(f"data: {data}\n\n".encode())
                    await asyncio.wait_for(writer.drain(),
                                           self.drain_timeout_s)
                    with self._lock:
                        self.stats["sse_tokens"] += 1
                elif kind == "terminal":
                    final = self._result_body(req)
                    writer.write(
                        (f"data: {json.dumps(final)}\n\n"
                         f"data: [DONE]\n\n").encode())
                    await asyncio.wait_for(writer.drain(),
                                           self.drain_timeout_s)
                    break
                else:                    # backend failure
                    writer.write(
                        (f"data: "
                         f"{json.dumps({'error': val, 'status': 500})}"
                         f"\n\n").encode())
                    await asyncio.wait_for(writer.drain(),
                                           self.drain_timeout_s)
                    # _fail_open_streams dropped this stream from
                    # _streams, so _pump never tallies it — count the
                    # 500 here to keep responses == requests
                    with self._lock:
                        resp = self.stats["http_responses"]
                        resp["500"] = resp.get("500", 0) + 1
                    break
        except asyncio.TimeoutError:
            self._client_gone(st, "slow reader: drain exceeded "
                                  f"{self.drain_timeout_s}s",
                              slow=True)
        except (ConnectionResetError, BrokenPipeError, OSError):
            self._client_gone(st, "client disconnected mid-stream")
        finally:
            if not watch.done():
                watch.cancel()

    async def _blocking_response(self, st: _Stream, reader, writer):
        req = st.request
        watch = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                kind, val = await self._wait_item(st, watch)
                if kind == "terminal":
                    body = self._result_body(req)
                    await self._respond_json(
                        writer, body["status"], body,
                        retry_after=req.retry_after_s,
                        count=False)     # _pump tallied at retirement
                    break
                if kind == "error":
                    await self._respond_json(writer, 500,
                                             {"error": val})
                    break
        except (ConnectionResetError, BrokenPipeError, OSError):
            self._client_gone(st, "client disconnected while waiting")
        finally:
            if not watch.done():
                watch.cancel()


# --------------------------------------------------------------------- #
# stdlib client helpers — the ONE audited client the tests and
# chip_smoke.py drive the server with
# --------------------------------------------------------------------- #

def _recv_headers(sock) -> Tuple[int, dict, bytes]:
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("connection closed before headers")
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return status, headers, rest


def _request_bytes(host: str, method: str, path: str,
                   payload) -> bytes:
    body = b"" if payload is None else json.dumps(payload).encode()
    return (f"{method} {path} HTTP/1.1\r\n"
            f"Host: {host}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode() + body


def http_request(host: str, port: int, method: str, path: str,
                 payload=None, timeout: float = 30.0):
    """One plain (non-streaming) HTTP exchange. Returns ``(status,
    headers, parsed-JSON-or-raw-bytes)``."""
    with socket.create_connection((host, port),
                                  timeout=timeout) as sock:
        sock.sendall(_request_bytes(host, method, path, payload))
        status, headers, rest = _recv_headers(sock)
        want = int(headers.get("content-length", "0") or 0)
        while len(rest) < want:
            chunk = sock.recv(65536)
            if not chunk:
                break
            rest += chunk
    body = rest
    if headers.get("content-type", "").startswith("application/json"):
        try:
            body = json.loads(rest.decode("utf-8"))
        except ValueError:
            pass
    return status, headers, body


def stream_completion(host: str, port: int, payload: dict, *,
                      abort_after_tokens: Optional[int] = None,
                      read_delay_s: float = 0.0,
                      recv_buf: Optional[int] = None,
                      timeout: float = 60.0):
    """Drive one SSE completion. Returns a dict with ``status``,
    ``headers``, ``tokens`` (ids), ``stamps`` (client receive times
    per token — the client-side TTFT/TPOT evidence), ``final`` (the
    terminal event, or None), ``aborted``.

    ``abort_after_tokens`` hard-closes the socket after that many
    token events — the mid-stream-disconnect chaos client;
    ``read_delay_s`` sleeps before every recv — the slow-reader
    chaos client (pair with a small ``recv_buf`` so kernel buffering
    does not hide the stall)."""
    payload = dict(payload)
    payload.setdefault("stream", True)
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        if recv_buf:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                            int(recv_buf))
        sock.sendall(_request_bytes(host, "POST", "/v1/completions",
                                    payload))
        status, headers, buf = _recv_headers(sock)
        out = {"status": status, "headers": headers, "tokens": [],
               "stamps": [], "final": None, "aborted": False}
        if status != 200:
            want = int(headers.get("content-length", "0") or 0)
            while len(buf) < want:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
            try:
                out["final"] = json.loads(buf.decode("utf-8"))
            except ValueError:
                pass
            return out
        if abort_after_tokens == 0:
            # hang up before reading a single event — the cancel-
            # while-queued / cancel-mid-prefill chaos client
            out["aborted"] = True
            return out
        done = False
        while not done:
            idx = buf.find(b"\n\n")
            if idx < 0:
                if read_delay_s:
                    time.sleep(read_delay_s)
                chunk = sock.recv(4096)
                if not chunk:
                    break
                buf += chunk
                continue
            raw, buf = buf[:idx], buf[idx + 2:]
            for line in raw.split(b"\n"):
                if not line.startswith(b"data: "):
                    continue
                data = line[6:].decode("utf-8")
                if data == "[DONE]":
                    done = True
                    break
                obj = json.loads(data)
                if "token" in obj:
                    out["tokens"].append(int(obj["token"]))
                    out["stamps"].append(time.perf_counter())
                    if abort_after_tokens is not None and \
                            len(out["tokens"]) >= abort_after_tokens:
                        out["aborted"] = True
                        return out
                elif obj.get("done"):
                    out["final"] = obj
        return out
    finally:
        try:
            sock.close()
        except OSError:
            pass
