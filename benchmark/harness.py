"""The benchmark's run of one cell: set-up, warm-up, the measured window,
the check of what the window produced against the plain reference, and
the metrics that ``BENCHMARK.json`` names for the cell.

Everything a cell is made of is found by name: the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<traffic>.json``,
read by ``make_traffic``), the driver that the mix names
(``drivers/<driver>.py``), each metric's reader (``metrics/<metric>.py``)
and the cell's limits (``limits/<cell>.json``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import statistics
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3tts_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is the JAX
    package's or JAX's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, imported by its path."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


@dataclass
class Record:
    """One request as the window served it."""

    request: object
    unit: int
    t0: float
    t1: float
    frames: int  # frames produced
    audio: object  # numpy waveform (None if none came)
    codes: object  # [frames, 16] on the device or numpy
    first_token: float | None = None
    first_audio: float | None = None

    @property
    def audio_s(self) -> float:
        return 0.0 if self.audio is None else len(self.audio) / 24000.0


@dataclass
class Run:
    """What the metric readers read."""

    records: list
    window_s: float
    setup_s: float
    units: list = field(default_factory=list)  # (unit index, t0, t1)
    spans: list = field(default_factory=list)
    calls: list = field(default_factory=list)
    busy_s: float | None = None


def quantile(xs, q: float) -> float | None:
    """The q-quantile of xs, linear between order statistics (the
    'inclusive' method)."""
    if not xs:
        return None
    if len(xs) == 1:
        return float(xs[0])
    return float(statistics.quantiles(xs, n=100, method="inclusive")[round(q * 100) - 1])


def metric_names(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones (``--trace 0``) or its
    per-layer ones (``--trace 1``)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


class Bench:
    """The program under test at one configuration, and its sampling."""

    def __init__(self, cfg: dict, traffic: dict, device, seed: int):
        import torch

        from qwen3tts_tpu_torch import config as C
        from qwen3tts_tpu_torch.models import talker as tk
        from qwen3tts_tpu_torch.models.generate import SamplingConfig
        from qwen3tts_tpu_torch.ops.quant import quantize_decode_params_int8
        from qwen3tts_tpu_torch.tts import Qwen3TTSModel

        import weights
        from tokenizer import StubTokenizer

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.talker_w, self.cp_w, self.voc_w = weights.make(cfg, seed, device)
        tcfg = C.TalkerConfig.from_dict(cfg["talker_config"])
        dec = C.TokenizerDecoderConfig.from_dict(cfg["decoder_config"])
        # the program's int8 set-up, as its loader runs it: fuse, then quantise
        tp, cp = dict(self.talker_w), dict(self.cp_w)
        tp["layers"] = tk.fuse_layer_projections(self.talker_w["layers"])
        cp["layers"] = tk.fuse_layer_projections(self.cp_w["layers"])
        self.model = Qwen3TTSModel(
            C.ModelConfig(talker_config=tcfg, tts_model_type="custom_voice",
                          tts_model_size=cfg["tts_model_size"]),
            quantize_decode_params_int8(tp, "codec_head"), quantize_decode_params_int8(cp, "lm_head"),
            self.voc_w, tokenizer_config=C.TokenizerConfig(decoder_config=dec),
            tokenizer=StubTokenizer(tcfg.text_vocab_size), dtype=torch.bfloat16, device=device,
        )
        s = traffic["sampling"]
        self._sampled = SamplingConfig(s["temperature"], s["top_k"], s["top_p"],
                                       s["repetition_penalty"], forbid_eos=True)
        self._greedy = self._sampled._replace(temperature=0.0)
        self.speakers = sorted(dict(cfg["talker_config"]["spk_id"]))

    def sampling(self, request):
        return self._greedy if request.greedy else self._sampled


def check_outputs(bench: Bench, records: list, seed: int, check_frames: int,
                  control: bool = False) -> dict:
    """Compare a sample of the window's greedy requests with the reference
    (or, with ``control``, the reference's lower precisions with it).

    The sample, drawn from the seed, holds the longest greedy request served
    and others until ``check_frames`` frames. Returns the numbers compared:
    the widest gap by which a served code 0 or CP code lies below the
    reference's best logit, the widest sample error of the waveform, and
    the count of requests served short of their frames."""
    import torch

    from reference.model import CHAT_ASSISTANT, Reference, code0_scores

    short = sum(1 for r in records
                if r.frames != r.request.frames or r.audio is None or len(r.audio) == 0)
    greedy = [r for r in records if r.request.greedy and r.frames == r.request.frames]
    out = {"short_requests": float(short)}
    if not greedy:
        return dict(out, code0_gap=float("inf"), cp_gap=float("inf"), wav_err=float("inf"))
    rng = random.Random(seed ^ 0xC0DE)
    longest = max(greedy, key=lambda r: r.frames)
    rest = [r for r in greedy if r is not longest]
    rng.shuffle(rest)
    sample, total = [longest], longest.frames
    for r in rest:
        if total >= check_frames:
            break
        sample.append(r)
        total += r.frames
    ref = Reference(bench.cfg, bench.talker_w, bench.cp_w, bench.voc_w, bits=8)
    if control:  # one step below the configuration: int4 weights, a TF32 vocoder
        low = Reference(bench.cfg, bench.talker_w, bench.cp_w, bench.voc_w, bits=4)
        low_voc = Reference(bench.cfg, bench.talker_w, bench.cp_w, bench.voc_w, tf32=True)
    pen = bench.traffic["sampling"]["repetition_penalty"]
    from tokenizer import StubTokenizer

    tok = StubTokenizer(bench.cfg["talker_config"]["text_vocab_size"])
    gaps0, gaps_cp, errs = [], [], []
    with torch.no_grad():
        for r in sample:
            codes = torch.as_tensor(np.asarray(r.codes if not torch.is_tensor(r.codes)
                                               else r.codes.cpu()), device=bench.device).long()
            ids = tok.encode(CHAT_ASSISTANT.format(r.request.text))
            rows, trailing, pad = ref.prompt(ids, r.request.speaker)
            hid = ref.talker_hidden(rows, trailing, pad, codes)
            z = code0_scores(ref.code0_logits(hid), codes[:, 0], pen)
            cpl = ref.cp_logits(hid, codes)
            wav = ref.vocode(codes)
            if control:
                lhid = low.talker_hidden(rows, trailing, pad, codes)
                pick0 = code0_scores(low.code0_logits(lhid), codes[:, 0], pen).argmax(-1)
                pick_cp = low.cp_logits(lhid, codes).argmax(-1)
                served_wav = low_voc.vocode(codes)
            else:
                pick0, pick_cp = codes[:, 0], codes[:, 1:]
                served_wav = torch.as_tensor(np.asarray(r.audio), device=bench.device)
            gaps0.append(float((z.max(-1).values - z.gather(-1, pick0[:, None])[:, 0]).max()))
            gaps_cp.append(float((cpl.max(-1).values - cpl.gather(-1, pick_cp[..., None])[..., 0]).max()))
            valid = int((codes[:, 0] > 0).sum()) * 1920  # the program's cut of the samples
            expect = wav[:valid] if 0 < valid < wav.shape[0] else wav
            if control:
                served_wav = served_wav[: expect.shape[0]]
            n = served_wav.shape[0]
            errs.append(float((served_wav - expect[:n]).abs().max()) if n == expect.shape[0]
                        else float("inf"))
    return dict(out, code0_gap=max(gaps0), cp_gap=max(gaps_cp), wav_err=max(errs),
                checked_frames=float(total))


def read_metrics(names: list[dict], run: Run) -> dict:
    """{name: {"value", "unit"}} of the metrics whose readers found something."""
    out = {}
    for m in names:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each number compared beside its limit; correct iff every one is
    within it."""
    shown = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    return all(checks[k] <= limits[k] for k in limits), shown


def env_dirs(root: Path) -> None:
    """Fixed cache directories inside the checkout for every build or kernel
    cache a library of the program could use."""
    cache = root / "build" / "bench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["USE_JAX"] = "0"
