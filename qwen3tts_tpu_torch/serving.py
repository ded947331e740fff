"""Continuous batching: a slot-based serving loop over the lockstep decoder
(port of qwen3tts_tpu/serving.py).

The static batch (``Qwen3TTSModel.generate_batch``) runs every sequence
until the last one finishes, so with ragged lengths the freed rows idle.
Here finished slots are refilled with queued requests between decode
chunks:

  admit B requests -> a chunk of lockstep frames -> harvest finished slots
  -> admit queued requests into the freed slots (``batch_generate.admit_slot``:
  a one-sequence prefill copied into the batch cache) -> the next chunk ...
  until the queue and the slots are empty.

One shared trailing-text bucket, one ``max_frames`` codes buffer and one
cache for the life of a server (``ContinuousBatcher.run`` makes one a
call). On CUDA every lockstep frame runs K1 and K2 at B = slots
(``_require_kernels``: 1..256 rows of a fused layout) and every admission's
first frame K2 at B = 1; on packed weights every matmul runs K4 (one row)
or ``quant_gemm`` (more), and K1 and K2 never. The host keeps a per-slot sampling table
(``samp`` [B, 4] numpy) and ``batch_generate`` hands it to the kernels'
per-row sampler once a call, in both sampling modes: ``sampling.per_request``
only decides whether a request may override the service's values. Values
are checked at submit (``_check_item``), never in the worker. Each admission and each chunk is one turn of
the device (``generate.device_turn``), so a server's worker and a
``generate()`` on another thread take turns on the card.

The loop always runs the per-shard functions of parallel/dp.py over a
list of per-shard carries. A ``dp_mesh`` (tp=1) splits the slots over
replicas: slot s lives on shard s // (B/dp), each admission runs on its
owner shard, each chunk on every shard that has work (shards on distinct
cards at once), with its own lockstep bound, and the next request goes to
the least-loaded shard. Without one the server is the one-shard case on
the model's device; a model sharded over a tensor-parallel ``mesh`` decodes
that one shard on its sharded caches. ``_route_device_fns`` picks the shard
mesh.
"""

from __future__ import annotations

import math
import threading
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from .models import batch_generate as bg
from .models import talker as tk
from .models.generate import SamplingConfig, pad_to_bucket
from .parallel import dp as pdp
from .parallel.mesh import Mesh

# A streamed slot short of this many frames makes the worker run chunks of
# at most 8 frames, so its first audio window is not gated on a whole
# chunk_frames decode. The JAX server's literal 16, mirrored; the first
# window needs STREAM_FIRST_AUDIO_FRAMES + STREAM_LOOKAHEAD_FRAMES = 12.
STREAM_WARMUP_FRAMES = 16
WARMUP_CHUNK = 8


class SlotProgress:
    """Coalescing progress feed of one streamed request in the server.

    The worker ``publish()``es the slot's cumulative codes after each
    decode chunk; the consumer (``TTSService.submit_stream``'s generator)
    blocks in ``wait_beyond(watermark)`` until frames beyond its watermark
    exist. Only the latest snapshot is kept, so a stalled consumer costs one
    snapshot of host memory and never blocks the worker. ``cancel()`` tells
    the worker to stop decoding the slot: it is harvested before the next
    chunk, so an abandoned stream frees its slot within one chunk. After a
    cancel ``wait_beyond`` reports the feed done (the JAX feed returned the
    same snapshot again, so a consumer that did not own the cancel spun)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._codes: np.ndarray | None = None  # [n, 16] cumulative
        self._n = 0
        self._done = False
        self._exc: BaseException | None = None
        self.cancelled = False

    def publish(self, codes: np.ndarray, n: int, done: bool):
        with self._cond:
            self._codes, self._n = codes, n
            self._done = self._done or done
            self._cond.notify_all()

    def fail(self, exc: BaseException):
        with self._cond:
            self._exc = exc
            self._done = True
            self._cond.notify_all()

    def cancel(self):
        with self._cond:
            self.cancelled = True
            self._cond.notify_all()

    def wait_beyond(self, watermark: int, timeout: float | None = None):
        """Block until frames beyond ``watermark`` exist, or the request
        finished, failed or was cancelled. Returns (codes [n, 16], n, done);
        done is true once the request finished or was cancelled."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._n > watermark or self._done or self.cancelled, timeout=timeout
            )
            if not ok:
                raise TimeoutError(f"no progress past frame {watermark} within {timeout}s")
            if self._exc is not None:
                raise self._exc
            codes = self._codes if self._codes is not None else np.zeros((0, 16), np.int32)
            return codes, self._n, self._done or self.cancelled


class ServiceOverloaded(RuntimeError):
    """Raised by ``Qwen3TTSServer.submit`` when the bounded request queue is
    full: backpressure instead of unbounded memory growth. The HTTP front
    end maps it to 429."""


@dataclass
class BatchItem:
    """One synthesis request: its prompt tensors and decode cap.

    The four sampling fields override the service-wide values for this
    request on a batcher or server built with ``sampling.per_request``; on
    any other, setting one raises (a silent fallback to the shared values
    would be worse than the error)."""

    prefill_embeds: torch.Tensor  # [1, P, h] (unpadded)
    trailing: torch.Tensor  # [T, h] (unpadded)
    max_steps: int
    seed: int = 0
    temperature: float | None = None
    top_k: int | None = None
    top_p: float | None = None
    repetition_penalty: float | None = None


@dataclass
class BatchOutput:
    codes: np.ndarray  # [n_frames, 16]
    n_frames: int
    lockstep_iterations: int = 0  # loop iterations while this request decoded


def _default_rows(sampling: SamplingConfig, B: int) -> np.ndarray:
    """[B, 4] f32: the service-wide values in every row."""
    row = [sampling.temperature, float(sampling.top_k), sampling.top_p,
           sampling.repetition_penalty]
    return np.tile(np.asarray(row, np.float32), (B, 1))


def _samp_row(item: BatchItem, sampling: SamplingConfig) -> np.ndarray:
    """[4] f32 sampling row of one slot (the item's overrides, else the
    defaults)."""
    pick = lambda v, d: d if v is None else v  # noqa: E731
    return np.asarray([
        pick(item.temperature, sampling.temperature),
        float(pick(item.top_k, sampling.top_k)),
        pick(item.top_p, sampling.top_p),
        pick(item.repetition_penalty, sampling.repetition_penalty),
    ], np.float32)


def _check_item(item: BatchItem, sampling: SamplingConfig) -> None:
    """Refuse at submit what the worker must not meet: sampling overrides on
    a service that freezes sampling, a sampling value outside its domain
    (not finite, or a penalty <= 0), a seed the generator cannot take. Such
    a value would fault the device inside the worker's decode, and with it
    every request in flight; here it fails its own request (ValueError, a
    400 over HTTP)."""
    if not sampling.per_request and any(
            v is not None for v in (item.temperature, item.top_k, item.top_p,
                                    item.repetition_penalty)):
        raise ValueError(
            "per-request sampling overrides require a service built with per-request "
            "sampling enabled (sampling.per_request=True; e.g. "
            "model.serve(per_request_sampling=True))"
        )
    check_samp_row(_samp_row(item, sampling))
    if not 0 <= item.seed < 2**63:
        raise ValueError(f"seed {item.seed} is outside [0, 2**63)")


def check_samp_row(row) -> None:
    """Raise ValueError unless (temperature, top_k, top_p,
    repetition_penalty) are finite and the penalty is > 0. A NaN
    temperature or top_p leaves the sampler no winner; a penalty of 0
    divides a logit of 0 by 0."""
    t, k, p, r = (float(v) for v in row)
    if not all(math.isfinite(v) for v in (t, k, p, r)):
        raise ValueError(f"sampling values must be finite: temperature {t}, top_k {k}, "
                         f"top_p {p}, repetition_penalty {r}")
    if r <= 0:
        raise ValueError(f"repetition_penalty must be > 0, got {r}")


def _route_device_fns(dp_mesh, mesh, slots, device):
    """(dp, the shard mesh of the serving calls): ``dp_mesh`` itself (a
    tp=1 mesh that divides ``slots``: weights replicated, slot s on shard
    s // (slots/dp)), or without one a one-shard mesh on ``device``."""
    if dp_mesh is None:
        return 1, Mesh([[device]])
    if mesh is not None:
        raise ValueError(
            "dp_mesh replicates the single-chip configuration; it "
            "does not compose with a TP mesh (pass one or the other)"
        )
    dp = pdp.dp_size(dp_mesh)
    if slots % dp != 0:
        raise ValueError(
            f"slots={slots} must be divisible by the dp size {dp} "
            "(each shard owns slots/dp cache slots)"
        )
    return dp, dp_mesh


def _pick_free_slot(occupied: list, dp: int = 1) -> int | None:
    """The next slot to admit into: the first free slot of the LEAST-LOADED
    shard (slot s lives on shard s // (slots/dp); one shard: the first free
    slot). A shard's step time grows with its active rows, so packing the
    low slots would run every chunk at the busiest shard's speed while the
    others idle."""
    lb = len(occupied) // dp
    best, best_load = None, None
    for sh in range(dp):
        rows = range(sh * lb, (sh + 1) * lb)
        free = next((i for i in rows if not occupied[i]), None)
        if free is None:
            continue
        load = sum(bool(occupied[i]) for i in rows)
        if best_load is None or load < best_load:
            best, best_load = free, load
    return best


def _until_step(carry: list, chunk: int) -> list[int]:
    """The chunk's lockstep bound, one a shard (its own counter + chunk), so
    a shard that idled keeps chunk-granular harvest and admission instead
    of catching up to the busiest shard's counter in one long chunk."""
    return [c.step + chunk for c in carry]


def _one_carry(talker_cfg, B, max_frames, cache_len, dtype, kv_quant, device, seed, mesh=None):
    zeros = torch.zeros(B, dtype=torch.int32, device=device)
    generator, seed_words = bg._seed_words(seed, device)
    return bg.BatchCarry(
        step=0,
        steps=zeros.clone(),
        frames=zeros.clone(),
        done=torch.ones(B, dtype=torch.bool, device=device),
        cur_input=torch.zeros(B, 1, talker_cfg.hidden_size, dtype=dtype, device=device),
        cache=tk.make_cache(talker_cfg, B, cache_len, dtype, device, quantized=kv_quant,
                            mesh=mesh),
        offsets=zeros.clone(),
        seen=torch.zeros(B, talker_cfg.vocab_size, dtype=torch.bool, device=device),
        codes=torch.zeros(B, max_frames, talker_cfg.num_code_groups, dtype=torch.int32,
                          device=device),
        tokens=torch.zeros(B, max_frames, dtype=torch.int32, device=device),
        generator=generator,
        seed_words=seed_words,
    )


def _empty_carry(talker_cfg, slots, max_frames, cache_len, dtype, kv_quant, shard_mesh,
                 mesh=None) -> list:
    """The distributed carry with every slot idle (done), which admissions
    fill: one carry of slots/dp rows on each shard's device, shard s drawing
    from ``shard_seed(0, s)`` so shard streams never correlate; a one-shard
    carry's cache split over ``mesh`` under tensor parallelism."""
    devices = pdp.shard_devices(shard_mesh)
    return [_one_carry(talker_cfg, slots // len(devices), max_frames, cache_len, dtype,
                       kv_quant, d, pdp.shard_seed(0, s), mesh)
            for s, d in enumerate(devices)]


def _carry_rows(carry: list, name: str) -> np.ndarray:
    """A per-slot field of the distributed carry, on the host, in global
    slot order."""
    return np.concatenate([getattr(c, name).cpu().numpy() for c in carry])


def _slot_carry(carry: list, s: int):
    """(the shard carry that holds slot s, its row there)."""
    lb = carry[0].codes.shape[0]
    return carry[s // lb], s % lb


def _pad(x: torch.Tensor, rows: int, dtype, device) -> torch.Tensor:
    """x [..., n, h] right-padded with zero rows to ``rows``."""
    x = x.to(device=device, dtype=dtype)
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def _require_shard_kernels(talker_params, cp_params, talker_cfg, cp_cfg, slots, kv_quant,
                           shard_mesh):
    """``batch_generate._require_kernels`` for the server's decode: slots/dp
    rows on each shard's device."""
    devices = pdp.shard_devices(shard_mesh)
    for dev in devices:
        bg._require_kernels(talker_params, cp_params, talker_cfg, cp_cfg, dev,
                            slots // len(devices), kv_quant)


class ContinuousBatcher:
    """One call of continuous batching: ``run`` submits every item to a
    :class:`Qwen3TTSServer` of ``slots`` slots (at most one an item) with
    buckets fitted to the items, waits for them all and closes it. So the
    batcher and the server share one admit / chunk / harvest loop. The JAX
    batcher's first wave was one batched prefill seeded by all its items'
    seeds folded together; here each request is admitted on its own and its
    seed keys its first frame, as in the server. Greedy codes are the same
    either way; sampled ones are held by distribution."""

    def __init__(
        self,
        talker_params,
        cp_params,
        *,
        talker_cfg,
        cp_cfg,
        sampling: SamplingConfig,
        tts_pad_embed: torch.Tensor,  # [h]
        slots: int = 4,
        chunk_frames: int = 25,
        max_frames: int = 256,
        cache_len: int | None = None,
        dtype=torch.bfloat16,
        kv_quant: bool = False,
        mesh=None,
        dp_mesh=None,
    ):
        shard_mesh = _route_device_fns(dp_mesh, mesh, slots, tts_pad_embed.device)[1]
        _require_shard_kernels(talker_params, cp_params, talker_cfg, cp_cfg, slots, kv_quant,
                               shard_mesh)
        self.sampling = sampling
        self.slots = slots
        self.max_frames = max_frames
        self._kw = dict(talker_cfg=talker_cfg, cp_cfg=cp_cfg, sampling=sampling,
                        tts_pad_embed=tts_pad_embed, chunk_frames=chunk_frames,
                        max_frames=max_frames, cache_len=cache_len, dtype=dtype,
                        kv_quant=kv_quant, mesh=mesh, dp_mesh=dp_mesh)
        self._params = (talker_params, cp_params)
        self.total_iterations = 0  # lockstep decode iterations of the last run

    def run(self, items: list[BatchItem]) -> list[BatchOutput]:
        """Synthesize every item, refilling freed slots as they free up.
        Returns one BatchOutput per item, in input order; a bad item raises
        before any device work."""
        if not items:
            return []
        for it in items:
            _check_item(it, self.sampling)
        # dp keeps every slot: the shards' split is fixed by ``slots``
        server = Qwen3TTSServer(
            *self._params, **self._kw,
            slots=self.slots if self._kw["dp_mesh"] is not None else min(self.slots, len(items)),
            prompt_bucket=pad_to_bucket(max(it.prefill_embeds.shape[1] for it in items)),
            trailing_bucket=pad_to_bucket(max(max(it.trailing.shape[0] for it in items), 1)),
        )
        try:
            with server._lock:  # the worker takes them all at once: no timing in the result
                futs = [server.submit(it) for it in items]
            outs = [f.result() for f in futs]
        finally:
            server.close()
        self.total_iterations = server.total_iterations
        return outs


class Qwen3TTSServer:
    """Long-lived online serving over the continuous batcher.

    ``submit()`` is thread-safe and returns a ``concurrent.futures.Future``
    resolving to a :class:`BatchOutput`. One worker thread owns the device
    state: it admits queued requests into free cache slots between decode
    chunks, advances the active slots in lockstep, harvests finished
    sequences, and waits on a condition variable when idle. Every shape is
    fixed at construction (``prompt_bucket``, ``trailing_bucket``,
    ``max_frames``). The one-call equivalent is ``ContinuousBatcher.run``."""

    def __init__(
        self,
        talker_params,
        cp_params,
        *,
        talker_cfg,
        cp_cfg,
        sampling: SamplingConfig,
        tts_pad_embed: torch.Tensor,  # [h]
        slots: int = 4,
        chunk_frames: int = 25,
        max_frames: int = 256,
        prompt_bucket: int = 256,
        trailing_bucket: int = 64,
        cache_len: int | None = None,
        dtype=torch.bfloat16,
        kv_quant: bool = False,
        max_queue: int | None = None,
        mesh=None,
        dp_mesh=None,
    ):
        self.device = tts_pad_embed.device
        self.mesh, self.dp_mesh = mesh, dp_mesh
        self._dp, self._shard_mesh = _route_device_fns(dp_mesh, mesh, slots, self.device)
        _require_shard_kernels(talker_params, cp_params, talker_cfg, cp_cfg, slots, kv_quant,
                               self._shard_mesh)
        self.max_queue = max_queue
        self.talker_params = talker_params
        self.cp_params = cp_params
        self.talker_cfg = talker_cfg
        self.cp_cfg = cp_cfg
        check_samp_row(_default_rows(sampling, 1)[0])
        self.sampling = sampling
        self.tts_pad = tts_pad_embed.to(dtype)
        self.slots = slots
        self.chunk_frames = chunk_frames
        self.max_frames = max_frames
        self.prompt_bucket = prompt_bucket
        self.trailing_bucket = trailing_bucket
        self.cache_len = cache_len or -(-(prompt_bucket + max_frames) // 128) * 128
        self.dtype = dtype
        self.kv_quant = kv_quant
        self.total_iterations = 0

        self._lock = threading.Condition()
        self._queue: list = []  # [(BatchItem, Future, SlotProgress | None)]
        self._failable: list = []  # in-flight slot futures (worker-owned)
        self._slot_prog: list = []  # in-flight slot progress feeds (worker-owned)
        self._draining: list = []  # taken from the queue, not yet admitted
        self._stop = False
        self._thread = threading.Thread(target=self._worker, name="qwen3tts-server", daemon=True)
        self._started = False

    # -- client API ------------------------------------------------------
    def submit(self, item: BatchItem) -> Future:
        """Enqueue a request; returns a Future[BatchOutput].

        The Future's ``cancel()`` works while the request is still queued:
        the worker skips it without touching the device. Once admitted it is
        RUNNING and cancel does nothing, as concurrent.futures defines it.
        Raises :class:`ServiceOverloaded` when ``max_queue`` requests are
        already waiting (admitted slots do not count)."""
        return self._submit(item, None)

    def submit_stream(self, item: BatchItem):
        """Enqueue a streamed request: returns (Future[BatchOutput],
        :class:`SlotProgress`). The feed publishes the slot's cumulative
        codes after every chunk while the other slots keep decoding;
        ``progress.cancel()`` frees the slot within one chunk. Validation
        and backpressure as ``submit``."""
        prog = SlotProgress()
        return self._submit(item, prog), prog

    def _submit(self, item: BatchItem, prog):
        if item.prefill_embeds.shape[1] > self.prompt_bucket:
            raise ValueError(f"prompt {item.prefill_embeds.shape[1]} exceeds prompt_bucket "
                             f"{self.prompt_bucket}")
        if item.trailing.shape[0] > self.trailing_bucket:
            raise ValueError(f"trailing {item.trailing.shape[0]} exceeds trailing_bucket "
                             f"{self.trailing_bucket}")
        _check_item(item, self.sampling)
        fut = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError("server is closed")
            waiting = len(self._queue) + len(self._draining)
            if self.max_queue is not None and waiting >= self.max_queue:
                raise ServiceOverloaded(
                    f"request queue is full ({self.max_queue} waiting); retry later")
            self._queue.append((item, fut, prog))
            if not self._started:
                self._started = True
                self._thread.start()
            self._lock.notify()
        return fut

    def close(self, wait: bool = True):
        """Stop taking work; finish the requests already taken, then stop."""
        with self._lock:
            self._stop = True
            self._lock.notify()
        if wait and self._started:
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker ----------------------------------------------------------
    def _worker(self):
        try:
            self._worker_loop()
        except BaseException as ex:  # noqa: BLE001  (every pending future gets it)
            with self._lock:
                self._stop = True
                pending = self._queue + self._draining
                self._queue, self._draining = [], []
            for _, _, p in pending:
                if p is not None:
                    p.fail(ex)
            for p in self._slot_prog:
                if p is not None:
                    p.fail(ex)
            # queued futures are PENDING (cancellable), admitted ones RUNNING
            for _, f, _ in pending:
                if not f.done() and f.set_running_or_notify_cancel():
                    f.set_exception(ex)
            for f in self._failable:
                if f is not None and not f.done():
                    f.set_exception(ex)
            raise

    def _worker_loop(self):
        B, dev, dt = self.slots, self.device, self.dtype
        # one decode path in both modes: the kernels read the per-slot table
        # (a frozen service's rows all hold its defaults, bit-equal to the
        # scalar launch); per_request only decides whether items may
        # override them (_check_item)
        common = dict(talker_cfg=self.talker_cfg, cp_cfg=self.cp_cfg,
                      sampling=self.sampling._replace(per_request=True))
        dp, shards = self._dp, self._shard_mesh
        carry = _empty_carry(self.talker_cfg, B, self.max_frames, self.cache_len, dt,
                             self.kv_quant, shards, self.mesh)
        # one trailing buffer a shard, on its device
        trailing_all = [torch.zeros(B // dp, self.trailing_bucket, self.talker_cfg.hidden_size,
                                    dtype=dt, device=c.codes.device) for c in carry]
        trail_lens = np.zeros((B,), np.int32)
        # slot -> its Future / SlotProgress (None: idle, or a plain request's feed);
        # also read by _worker's failure path
        self._failable = slot_fut = [None] * B
        self._slot_prog = slot_prog = [None] * B
        known_frames = np.zeros((B,), np.int32)  # the host's view, for the warm-up
        slot_caps = np.zeros((B,), np.int32)
        start_step = np.zeros((B,), np.int64)  # carry.step at each slot's admission
        samp = _default_rows(self.sampling, B)  # the per-slot sampling table

        def harvest(s):
            fut, prog = slot_fut[s], slot_prog[s]
            slot_fut[s] = slot_prog[s] = None
            c, r = _slot_carry(carry, s)
            fr = int(c.frames[r])
            codes = c.codes[r, :fr].cpu().numpy().copy()
            if prog is not None:
                prog.publish(codes, fr, True)
            if not fut.done():  # RUNNING since admission
                fut.set_result(BatchOutput(codes=codes, n_frames=fr,
                                           lockstep_iterations=c.step - int(start_step[s])))

        while True:
            with self._lock:
                while not self._queue and not self._stop and all(f is None for f in slot_fut):
                    self._lock.wait()
                if self._stop and not self._queue and all(f is None for f in slot_fut):
                    return
                pending, self._queue = self._queue, []

            # admit into free slots, one request at a time on its owner
            # shard; requests not admitted yet stay in self._draining, so a
            # fault inside an admission still reaches their futures (the
            # rest go back to the queue's head). One at a time: on four
            # H100s, four cards' admissions on four host threads at once
            # took 3-5x longer than one after another (PERF.md, Findings)
            self._draining = pending
            while self._draining:
                s = _pick_free_slot([f is not None for f in slot_fut], dp)
                if s is None:
                    break
                item, fut, prog = self._draining.pop(0)
                if prog is not None and prog.cancelled:
                    fut.cancel()  # a stream abandoned while queued (still PENDING)
                    continue
                if not fut.set_running_or_notify_cancel():
                    continue  # cancelled while queued: no device work at all
                slot_fut[s], slot_prog[s] = fut, prog  # before the device call
                samp[s] = _samp_row(item, self.sampling)
                carry, trailing_all = pdp.admit_slot_dp(
                    self.talker_params, self.cp_params, carry, trailing_all, mesh=shards,
                    **common, slot=s,
                    prefill_embeds=_pad(item.prefill_embeds, self.prompt_bucket, dt, dev),
                    prefill_len=item.prefill_embeds.shape[1],
                    trailing_row=_pad(item.trailing, self.trailing_bucket, dt, dev),
                    trailing_len=item.trailing.shape[0], tts_pad_embed=self.tts_pad,
                    seed=item.seed, samp_row=samp[s:s + 1],
                )
                c, r = _slot_carry(carry, s)
                start_step[s] = c.step
                slot_caps[s] = min(item.max_steps, self.max_frames)
                trail_lens[s] = item.trailing.shape[0]
                known_frames[s] = 1
                if bool(c.done[r]):  # EOS on the first frame
                    harvest(s)
            if self._draining:
                with self._lock:
                    self._queue = self._draining + self._queue
                self._draining = []

            # an abandoned stream frees its slot now: harvested on the host
            # with the frames decoded so far, then idle at cap 0 until an
            # admission resets it
            for s in range(B):
                if slot_fut[s] is not None and slot_prog[s] is not None and slot_prog[s].cancelled:
                    harvest(s)
            if all(f is None for f in slot_fut):
                continue

            # one lockstep chunk over the active slots; shorter while a
            # streamed slot is still short of its first audio window
            warming = any(slot_prog[s] is not None and slot_fut[s] is not None
                          and known_frames[s] < STREAM_WARMUP_FRAMES for s in range(B))
            chunk_now = min(self.chunk_frames, WARMUP_CHUNK) if warming else self.chunk_frames
            active = np.asarray([f is not None for f in slot_fut])
            max_steps = np.where(active, slot_caps, 0).astype(np.int32)
            carry = pdp.generate_chunk_batch_dp(
                self.talker_params, self.cp_params, carry, mesh=shards, **common,
                trailing_embeds=trailing_all, trailing_lens=torch.from_numpy(trail_lens.copy()),
                tts_pad_embed=self.tts_pad, max_steps=torch.from_numpy(max_steps),
                until_step=_until_step(carry, chunk_now), samp_vec=samp,
            )
            self.total_iterations = pdp.global_step(carry)

            done, frames = _carry_rows(carry, "done"), _carry_rows(carry, "frames")
            streaming = [s for s in range(B) if slot_fut[s] is not None and slot_prog[s] is not None]
            if streaming:
                known_frames[:] = frames
                codes = _carry_rows(carry, "codes")
                for s in streaming:
                    if not done[s]:  # a finished slot's harvest publishes its last state
                        slot_prog[s].publish(codes[s, : frames[s]].copy(), int(frames[s]), False)
            for s in range(B):
                if slot_fut[s] is not None and done[s]:
                    harvest(s)
