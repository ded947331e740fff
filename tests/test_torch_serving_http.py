"""The port's HTTP front end (``qwen3tts_tpu_torch.serving_http``) on
127.0.0.1, over ``model.serve()`` of a synthetic checkpoint loaded with
``from_pretrained`` on the CPU (tests/test_torch_serving.py's
``service_model``): /synthesize gives a RIFF WAV, /synthesize_stream a
chunked RIFF of whole codec frames, /healthz its JSON; a bad speaker is a
400 on both endpoints, a full queue a 429, and per-request sampling fields
are taken (200) by a per-request service and refused (400) by a frozen
one, as are values the sampler cannot take (not finite, a penalty of 0).
Port only: the waveforms' numbers are held in
tests/test_torch_serving.py and tests/test_torch_batch.py."""

import contextlib
import http.client
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3tts_tpu_torch.serving_http import make_server

from test_torch_serving import service_model

SERVE = dict(slots=2, chunk_frames=3, max_frames=16, prompt_bucket=64, trailing_bucket=16)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return service_model(tmp_path_factory)


@contextlib.contextmanager
def http_service(model, **kw):
    """``model.serve(**kw)`` behind ``make_server`` on a free local port;
    yields the port."""
    with model.serve(**dict(SERVE, **kw)) as svc:
        srv = make_server(svc, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            yield srv.server_address[1]
        finally:
            srv.shutdown()
            srv.server_close()


def post(port, path, body, timeout=600):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_synthesize_stream_and_health(model):
    with http_service(model) as port:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True, "requests": 0}
        code, kind, body = post(port, "/synthesize",
                                {"text": "Hello web", "speaker": "Aiden", "max_tokens": 6})
        assert (code, kind) == (200, "audio/wav")
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE" and len(body) > 44
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/synthesize_stream", headers={"Content-Type": "application/json"},
                     body=json.dumps({"text": "Chunked stream", "speaker": "Aiden",
                                      "max_tokens": 8, "chunk_frames": 2}))
        r = conn.getresponse()
        assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
        assert r.headers["Transfer-Encoding"] == "chunked"
        stream = r.read()  # http.client undoes the chunked framing
        conn.close()
        assert stream[:4] == b"RIFF" and stream[36:40] == b"data"
        pcm = np.frombuffer(stream[44:], dtype="<i2")
        assert pcm.size > 0 and pcm.size % 1920 == 0  # whole codec frames
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["requests"] == 2
        for path in ("/synthesize", "/synthesize_stream"):
            code, _, out = post(port, path, {"text": "x", "speaker": "NoSuch"}, timeout=60)
            assert code == 400 and "NoSuch" in json.loads(out)["error"], path
        assert post(port, "/synthesize", b"{}", timeout=60)[0] == 400  # no text
        assert post(port, "/synthesize", {"text": "x", "top_k": "many"}, timeout=60)[0] == 400


def test_a_full_queue_is_429(model):
    """Eight concurrent posts to one slot with one waiting place: the tail
    is shed with 429 and the accepted requests complete."""
    codes = []
    with http_service(model, slots=1, max_queue=1) as port:
        def one(i):
            codes.append(post(port, "/synthesize",
                              {"text": f"flood {i}", "speaker": "Aiden", "max_tokens": 8})[0])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert 429 in codes and 200 in codes and set(codes) <= {200, 429}, codes


def test_per_request_sampling_fields(model):
    """Sampling fields in a body: taken on a per-request service (200 on
    both endpoints), refused on a frozen one (400 naming per-request)."""
    body = {"text": "Sampled", "speaker": "Aiden", "max_tokens": 6, "temperature": 0.0,
            "top_k": 1, "top_p": 0.9, "repetition_penalty": 1.1}
    with http_service(model, per_request_sampling=True) as port:
        for path, extra in (("/synthesize", {}), ("/synthesize_stream", {"chunk_frames": 2})):
            code, _, out = post(port, path, dict(body, **extra))
            assert code == 200 and out[:4] == b"RIFF", path
    with http_service(model) as port:
        for path in ("/synthesize", "/synthesize_stream"):
            code, _, out = post(port, path, body, timeout=60)
            assert code == 400 and "per-request" in json.loads(out)["error"], path


def test_values_the_sampler_cannot_take_are_400(model):
    """A NaN temperature (a JSON NaN and a "nan" string), a NaN top_p, a
    penalty of 0 and an infinite seed are each a 400 on both endpoints;
    the service then still serves a request (none of them reached the
    worker)."""
    base = {"text": "Bad values", "speaker": "Aiden", "max_tokens": 4}
    bad = [{"temperature": float("nan")}, {"temperature": "nan"}, {"top_p": float("nan")},
           {"repetition_penalty": 0}, {"seed": float("inf")}]
    with http_service(model, per_request_sampling=True) as port:
        for path in ("/synthesize", "/synthesize_stream"):
            for extra in bad:
                code, _, out = post(port, path, dict(base, **extra), timeout=60)
                assert code == 400 and "bad request" in json.loads(out)["error"], (path, extra)
        code, _, out = post(port, "/synthesize", base)
        assert code == 200 and out[:4] == b"RIFF"
