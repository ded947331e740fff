"""A minimal HTTP synthesis server over :class:`tts.TTSService` (port of
qwen3tts_tpu/serving_http.py; stdlib ``http.server`` only).

One service worker decodes with continuous batching; the HTTP threads
wait on their request's Future and send the WAV back.

  POST /synthesize   {"text": ..., "speaker"?: ..., "instruct"?: ...,
                      "language"?: "auto", "seed"?: 0, "max_tokens"?: 2048,
                      "temperature"?: ..., "top_k"?: ..., "top_p"?: ...,
                      "repetition_penalty"?: ...}
                     -> 200 audio/wav | 400 bad input | 429 queue full
                        | 500 server fault | 504 synthesis timeout
                     The sampling fields are per request; they need a
                     service made with per_request_sampling=True (``main``'s
                     default), else 400. K1 and K2 carry them row by row.
                     A value that is not finite, a repetition_penalty <= 0
                     or a seed outside [0, 2**63) is a 400 too.
  POST /synthesize_stream  the same body (+ "chunk_frames"?: 8)
                     -> 200 audio/wav in chunked transfer: the PCM leaves
                        as the request's slot decodes (submit_stream)
  GET  /healthz      -> 200 {"ok": true, "requests": N}

Run: ``python -m qwen3tts_tpu_torch.serving_http --model <dir> [--port 8080]
[--quantize int8] [--slots N] [--max-queue N]``; the model runs on the
CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import threading
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def make_server(service, host: str = "127.0.0.1", port: int = 8080,
                result_timeout: float = 600.0) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer bound to ``service`` (a ``tts.TTSService``).

    ``result_timeout`` bounds one request thread's wait on its Future: a
    stuck worker gives 504 instead of pinning the thread. Validation errors
    are 400, a full queue (``serve(max_queue=)``) 429, internal faults 500.
    """
    from .serving import ServiceOverloaded
    from .tts import AudioChunkEvent, Qwen3TTSError
    from .utils.audio import pcm16_bytes, wav_bytes, wav_stream_header

    stats = {"requests": 0}
    lock = threading.Lock()

    def request_kw(req: dict) -> dict:
        """submit's keywords from a request body (casts raise ValueError,
        TypeError or OverflowError: a 400)."""
        def opt(name, cast):
            v = req.get(name)
            return None if v is None else cast(v)

        return dict(
            speaker=req.get("speaker"), instruct=req.get("instruct"),
            language=req.get("language", "auto"), seed=int(req.get("seed", 0)),
            max_tokens=int(req.get("max_tokens", 2048)), temperature=opt("temperature", float),
            top_k=opt("top_k", int), top_p=opt("top_p", float),
            repetition_penalty=opt("repetition_penalty", float),
        )

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked transfer for /synthesize_stream

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _submit(self, fn, *a, **kw):
            """(the call's result, None), or (None, True) once an error
            response went out."""
            try:
                return fn(*a, **kw), None
            except ServiceOverloaded as e:
                self._json(429, {"error": str(e)})
            except (Qwen3TTSError, ValueError, TypeError, KeyError, OverflowError) as e:
                self._json(400, {"error": f"bad request: {e}"})
            return None, True

        def _stream(self, text: str, kw: dict):
            """Chunked WAV through the server's slots
            (``TTSService.submit_stream``): the first bytes leave at the
            first audio chunk, and a client that goes away cancels its slot
            within one decode chunk. The prompt is built before the 200
            header, so a bad speaker is a clean 400."""
            if service.model.vocoder_params is None:
                return self._json(400, {"error": "speech tokenizer not loaded"})
            stream, failed = self._submit(service.submit_stream, text, **kw)
            if failed:
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(b: bytes):
                if b:
                    self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")
                    self.wfile.flush()

            try:
                # closing the generator cancels the slot on every exit
                with contextlib.closing(stream):
                    chunk(wav_stream_header())
                    for ev in stream:
                        if isinstance(ev, AudioChunkEvent):
                            chunk(pcm16_bytes(ev.audio))
                self.wfile.write(b"0\r\n\r\n")
                with lock:
                    stats["requests"] += 1
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away; closing() freed the slot
            except Exception:  # noqa: BLE001  (a fault mid-stream: the truncated body says so)
                return

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "requests": stats["requests"]})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/synthesize", "/synthesize_stream"):
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
                kw = request_kw(req)
                if self.path == "/synthesize_stream":
                    kw["audio_chunk_frames"] = int(req.get("chunk_frames", 8))
            except (KeyError, ValueError, TypeError, OverflowError) as e:
                return self._json(400, {"error": f"bad request: {e}"})
            if self.path == "/synthesize_stream":
                return self._stream(text, kw)
            fut, failed = self._submit(service.submit, text, **kw)
            if failed:
                return
            try:
                audio = fut.result(timeout=result_timeout)
            except FuturesTimeout:
                fut.cancel()
                return self._json(504, {"error": "synthesis timed out"})
            except Exception as e:  # noqa: BLE001  (a worker or device fault)
                return self._json(500, {"error": str(e)})
            with lock:
                stats["requests"] += 1
            body = wav_bytes(audio)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    from .tts import Qwen3TTSModel

    ap = argparse.ArgumentParser(description="Qwen3-TTS HTTP server (PyTorch/CUDA)")
    ap.add_argument("--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--quantize", default=None, choices=[None, "int8"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="waiting-request bound; beyond it submits get 429 (0 = unbounded)")
    ap.add_argument("--no-per-request-sampling", action="store_true",
                    help="freeze sampling service-wide: temperature/top_k/top_p/"
                    "repetition_penalty in request bodies become 400s")
    args = ap.parse_args(argv)

    model = Qwen3TTSModel.from_pretrained(args.model, quantize=args.quantize)
    with model.serve(slots=args.slots, max_queue=args.max_queue or None,
                     per_request_sampling=not args.no_per_request_sampling) as service:
        srv = make_server(service, args.host, args.port)
        print(f"serving on http://{args.host}:{srv.server_address[1]}", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.shutdown()


if __name__ == "__main__":
    main()
