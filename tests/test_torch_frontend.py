"""The port's HTTP/SSE front end against the JAX package's.

``gpt_mini`` (f32, V = 64) is initialized in the JAX package and its
weights go across into the port. Held here, over localhost:

  - ``OUTCOME_HTTP_STATUS`` equal to the JAX dict (total, one distinct
    status per failure class); ``parse_request_payload`` giving equal
    requests, or the same refusal, on a table of payloads;
  - a blocking completion equal to the direct engine; SSE arriving
    incrementally; a disconnect cancelling the request and reclaiming
    its pages; shed (429) and deadline (504) statuses carrying
    ``Retry-After``, unservable 422, malformed 400 / 404 / 405;
    ``/metrics`` and ``/healthz``;
  - greedy tokens over HTTP equal to the JAX front end's on the same
    payloads, blocking and streamed;
  - a ``Router`` behind the front end (``build_fleet``): streamed and
    blocking tokens equal the router driven directly, ``/healthz``
    counting the replicas, a disconnect reclaiming on the replica.
"""

import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.base import MXNetError as JMXNetError
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.serve import InferenceEngine as JaxEngine
from incubator_mxnet_tpu.serve import ServeFrontend as JaxFrontend
from incubator_mxnet_tpu.serve import frontend as jfe

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.serve import (OUTCOME_HTTP_STATUS,
                                             InferenceEngine, Outcome,
                                             Request, ServeFrontend,
                                             build_fleet, stream_completion)
from incubator_mxnet_tpu_torch.serve import frontend as tfe
from incubator_mxnet_tpu_torch.serve.frontend import http_request

from test_torch_parity import port_gpt

V = 64
HOST = "127.0.0.1"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU runs here are tiny (gpt_mini): on one intra-op
    thread they do not contend with the other test processes for the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jmx.random.seed(0)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    tm = port_gpt(jm, vocab_size=V, max_length=64)
    return jm, tm


def _eng(model, Engine=InferenceEngine, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_len", 64)
    kw.setdefault("recorder", False)
    return Engine(model, **kw)


def _wait_finished(fe, n=1, timeout=20.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if len(fe.finished) >= n:
            return list(fe.finished)
        time.sleep(0.02)
    raise AssertionError(f"only {len(fe.finished)}/{n} finished")


# --------------------------------------------------------------------- #
# host-only: the status map and the payload schema
# --------------------------------------------------------------------- #

def test_outcome_status_map_equals_jax():
    assert {o.value: s for o, s in OUTCOME_HTTP_STATUS.items()} == \
        {o.value: s for o, s in jfe.OUTCOME_HTTP_STATUS.items()}
    assert set(OUTCOME_HTTP_STATUS) == set(Outcome)
    fail = [s for o, s in OUTCOME_HTTP_STATUS.items() if not o.ok]
    assert len(fail) == len(set(fail)) and min(fail) >= 400
    assert all(s == 200 for o, s in OUTCOME_HTTP_STATUS.items() if o.ok)
    assert tfe.outcome_status(Outcome.SHED) == 429


PAYLOADS = [
    {"prompt": [1, 2, 3]},
    {"prompt": [4, 5], "max_new_tokens": 7, "temperature": 0.5,
     "eos_id": 9, "deadline_s": 2.5, "seed": 11, "tier": "LATENCY",
     "stream": False},
    {"prompt": [6], "top_k": 5, "top_p": 0.9, "repetition_penalty": 1.2,
     "presence_penalty": 0.3, "logit_bias": {"3": 1.5}, "stop": [[1, 2]]},
    {"prompt": [7, 8], "eos_id": 3,
     "grammar": {"type": "choice", "sequences": [[1, 2], [4]]}},
    {"prompt": []}, {"prompt": [1], "nope": 1}, {"prompt": [999]},
    {"prompt": "hi"}, {"prompt": [1], "tier": "GOLD"},
    {"prompt": [1], "grammar": {"type": "??"}},
    {"prompt": [1], "stop": [[]]}, {"prompt": [1], "logit_bias": [1]},
    {"prompt": [1], "max_new_tokens": 0}, {"prompt": [1], "eos_id": -1,
                                           "grammar": {"type": "choice",
                                                       "sequences": [[1]]}},
    None, [1, 2],
]


def _parsed(mod, payload, errors):
    try:
        req, stream = mod.parse_request_payload(payload, V)
    except errors as e:
        return ("refused", type(e).__name__.replace("MXNetError", "E"),
                str(e))
    sp = req.sampling
    menu = None if sp is None else (
        sp.top_k, sp.top_p, sp.repetition_penalty, sp.presence_penalty,
        sp.logit_bias, sp.stop_sequences,
        None if sp.grammar is None else sp.grammar.vocab_size)
    return (list(req.prompt_ids), req.max_new_tokens, req.temperature,
            req.eos_id, req.deadline_s, req.seed, req.tier.value, menu,
            stream)


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_parse_request_payload_equals_jax(i):
    p = PAYLOADS[i]
    got = _parsed(tfe, p, (MXNetError, ValueError, KeyError, TypeError))
    want = _parsed(jfe, p, (JMXNetError, ValueError, KeyError, TypeError))
    assert got == want


# --------------------------------------------------------------------- #
# a port engine behind the front end
# --------------------------------------------------------------------- #

def test_blocking_completion_matches_direct_engine(models):
    _, tm = models
    prompt = [5, 6, 7, 8]
    ref = Request(np.array(prompt), max_new_tokens=8)
    _eng(tm).run([ref])
    eng = _eng(tm)
    with ServeFrontend(eng) as fe:
        status, _, body = http_request(HOST, fe.bound_port, "POST",
                                       "/v1/completions",
                                       {"prompt": prompt,
                                        "max_new_tokens": 8,
                                        "stream": False})
    assert status == 200 and body["outcome"] == "MAX_TOKENS"
    assert body["tokens"] == ref.token_ids and body["n_tokens"] == 8
    eng.audit_pages()


def test_sse_streams_tokens_incrementally(models):
    eng = _eng(models[1])
    with ServeFrontend(eng) as fe:
        out = stream_completion(HOST, fe.bound_port,
                                {"prompt": [3, 4, 5], "max_new_tokens": 24})
    assert out["status"] == 200 and "x-request-id" in out["headers"]
    assert out["final"]["outcome"] == "MAX_TOKENS"
    assert len(out["tokens"]) == 24
    assert out["tokens"] == out["final"]["tokens"]
    assert len({round(s, 4) for s in out["stamps"]}) >= 3
    assert eng.decode_trace_count == 1
    eng.audit_pages()


def test_disconnect_mid_stream_cancels_and_reclaims(models):
    eng = _eng(models[1])
    free0 = eng._alloc.free_count
    with ServeFrontend(eng) as fe:
        out = stream_completion(HOST, fe.bound_port,
                                {"prompt": [8, 9, 10],
                                 "max_new_tokens": 48},
                                abort_after_tokens=2)
        assert out["aborted"]
        finished = _wait_finished(fe)
        assert finished[0].outcome is Outcome.CANCELLED
        snap = fe.stats_snapshot()
        assert snap["disconnects"] == 1
        assert snap["http_responses"].get("499") == 1
    eng.audit_pages()
    assert eng._alloc.free_count == free0


def test_live_status_mapping_shed_deadline_unservable(models):
    tm = models[1]
    with ServeFrontend(_eng(tm, max_queue=0)) as fe:
        status, headers, body = http_request(
            HOST, fe.bound_port, "POST", "/v1/completions",
            {"prompt": [1, 2], "max_new_tokens": 4, "stream": False})
    assert status == 429 and body["outcome"] == "SHED"
    assert int(headers["retry-after"]) >= 1 and body["retry_after_s"] > 0
    with ServeFrontend(_eng(tm)) as fe:
        status, _, body = http_request(
            HOST, fe.bound_port, "POST", "/v1/completions",
            {"prompt": [1] * 40, "max_new_tokens": 60, "stream": False})
    assert status == 422 and body["outcome"] == "FAILED_UNSERVABLE"
    eng3 = _eng(tm, num_slots=1)
    with ServeFrontend(eng3) as fe:
        hold = {}

        def long_stream():
            hold["out"] = stream_completion(
                HOST, fe.bound_port, {"prompt": [2, 3, 4],
                                      "max_new_tokens": 48})

        t = threading.Thread(target=long_stream, daemon=True)
        t.start()
        t0 = time.perf_counter()
        while eng3.active_count == 0 and time.perf_counter() - t0 < 10:
            time.sleep(0.01)
        status, headers, body = http_request(
            HOST, fe.bound_port, "POST", "/v1/completions",
            {"prompt": [5, 6], "max_new_tokens": 4, "stream": False,
             "deadline_s": 0.01})
        assert status == 504 and body["outcome"] == "DEADLINE_EXPIRED"
        assert "retry-after" in headers
        t.join(timeout=30)
        assert hold["out"]["final"]["outcome"] == "MAX_TOKENS"
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 10:
            snap = fe.stats_snapshot()
            if snap["http_responses"].get("200") == 1:
                break
            time.sleep(0.02)
        assert snap["http_responses"].get("504") == 1
        assert sum(snap["http_responses"].values()) == snap["http_requests"]


def test_bad_requests_and_routes(models):
    with ServeFrontend(_eng(models[1])) as fe:
        port = fe.bound_port
        for payload in ({"prompt": []}, {"prompt": [1], "nope": 1},
                        {"prompt": [999]}, None):
            status, _, body = http_request(HOST, port, "POST",
                                           "/v1/completions", payload)
            assert status == 400 and "error" in body
        assert http_request(HOST, port, "GET", "/nothing")[0] == 404
        assert http_request(HOST, port, "GET", "/v1/completions")[0] == 405
        snap = fe.stats_snapshot()
        assert snap["http_requests"] == 6
        assert sum(snap["http_responses"].values()) == 6


def test_metrics_and_healthz(models):
    with ServeFrontend(_eng(models[1])) as fe:
        port = fe.bound_port
        http_request(HOST, port, "POST", "/v1/completions",
                     {"prompt": [1, 2], "max_new_tokens": 4,
                      "stream": False})
        status, _, health = http_request(HOST, port, "GET", "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["active_slots"] == 0
        status, _, text = http_request(HOST, port, "GET", "/metrics")
        text = text.decode() if isinstance(text, bytes) else text
    assert status == 200
    assert "mxtpu_serve_requests_total" in text
    assert "mxtpu_serve_http_requests_total 1" in text
    assert 'mxtpu_serve_http_responses_total{status="200"} 1' in text


def _http_tokens(Frontend, backend, payloads):
    out = []
    with Frontend(backend) as fe:
        for p in payloads:
            if p.get("stream", True):
                r = stream_completion(HOST, fe.bound_port, p)
                out.append((r["status"], r["tokens"],
                            r["final"]["outcome"]))
            else:
                status, _, body = http_request(HOST, fe.bound_port, "POST",
                                               "/v1/completions", p)
                out.append((status, body["tokens"], body["outcome"]))
    return out


HTTP_PAYLOADS = [
    {"prompt": [5, 6, 7, 8], "max_new_tokens": 8, "stream": False},
    {"prompt": [3, 4, 5], "max_new_tokens": 12},
    {"prompt": [7, 8, 9], "max_new_tokens": 10, "top_k": 3,
     "repetition_penalty": 1.3},
    {"prompt": [9, 1, 2, 3, 4], "max_new_tokens": 9, "eos_id": 17,
     "stream": False},
]


def test_greedy_over_http_equals_jax_frontend(models):
    jm, tm = models
    want = _http_tokens(JaxFrontend, _eng(jm, JaxEngine), HTTP_PAYLOADS)
    got = _http_tokens(ServeFrontend, _eng(tm), HTTP_PAYLOADS)
    assert got == want
    assert all(s == 200 for s, _, _ in got)


# --------------------------------------------------------------------- #
# a router behind the front end
# --------------------------------------------------------------------- #

FLEET_KW = dict(num_slots=2, page_size=8, max_len=64, chunk_pages=1,
                prefix_cache=True, recorder=False)


def test_router_behind_the_frontend(models):
    _, tm = models
    prompts = [[5, 6, 7, 8], [3, 4, 5], [9, 9, 1, 2, 3], [7, 8]]
    direct = build_fleet(tm, 2, engine_kw=FLEET_KW, seed=3,
                         heartbeat_timeout_s=30.0)
    ref = [Request(np.array(p), max_new_tokens=10) for p in prompts]
    direct.run(ref)
    rt = build_fleet(tm, 2, engine_kw=FLEET_KW, seed=3,
                     heartbeat_timeout_s=30.0)
    results = [None] * len(prompts)
    with ServeFrontend(rt) as fe:
        def one(i):
            p = {"prompt": prompts[i], "max_new_tokens": 10}
            if i == 3:
                p["stream"] = False
                results[i] = http_request(HOST, fe.bound_port, "POST",
                                          "/v1/completions", p)[2]["tokens"]
            else:
                results[i] = stream_completion(HOST, fe.bound_port,
                                               p)["tokens"]

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        status, _, health = http_request(HOST, fe.bound_port, "GET",
                                         "/healthz")
        assert status == 200 and health["replicas"]["SERVING"] == 2
        out = stream_completion(HOST, fe.bound_port,
                                {"prompt": [8, 9], "max_new_tokens": 60},
                                abort_after_tokens=2)
        assert out["aborted"]
        done = _wait_finished(fe, n=len(prompts) + 1)
        assert done[-1].outcome is Outcome.CANCELLED
        status, _, text = http_request(HOST, fe.bound_port, "GET",
                                       "/metrics")
        text = text.decode() if isinstance(text, bytes) else text
        assert "mxtpu_serve_fleet_size 2" in text
    assert results == [r.token_ids for r in ref]
    for rep in rt.replicas:
        rep.engine.audit_pages()
        assert rep.engine.active_count == 0


def test_frontend_refuses_a_double_start(models):
    fe = ServeFrontend(_eng(models[1]))
    with pytest.raises(MXNetError, match="not started"):
        fe.bound_port
    with fe:
        with pytest.raises(MXNetError, match="already started"):
            fe.start()
