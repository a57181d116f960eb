"""Continuous-batching decode engine: autoregressive serving of
``TransformerLM``, the counterpart of ``raydp_tpu/serve/decode.py``.

Orca-style iteration-level scheduling: the engine keeps a fixed number of
decode SLOTS and runs one model step per loop iteration; sequences join a
slot the moment one frees (after a prefill pass that warms their pages in
the ``PagedKVCache``) and leave the moment they finish. The prefill runs at
the fixed ``[1, capacity_tokens]`` shape (prompt zero-padded) and the decode
step at the fixed ``[max_seqs, 1]`` shape (empty slots carry a pad sequence
masked by ``kv_len``), so a step's numerics do not depend on which
sequences share it.

Determinism contract (docs/serving.md): with f32 q/k/v and an f32 cache a
decode step's attention equals the prefill pass's row bit for bit (the
kernel family in ``ops/flash_attention.py``). With bf16 q/k/v the prefill
runs on the tensor-core forward, which rounds p to bf16, and the decode row
is within bf16 rounding of the prefill row, not bitwise. Sampling is
greedy argmax.

Admission is vetoed by exact page arithmetic (a sequence is admitted only
when the pool holds its worst case, prompt + max_new, so a step never dies
on a full pool), by a full batch, and by host memory pressure above
``max_mem_pressure`` (``obs.profiler.current_mem_pressure``: host memory,
as in the JAX package; on the card the page pool is a device tensor that
gauge does not see, on the CPU a shm arena that it does). A vetoed stream
waits at the front of the queue; each veto is counted by cause in
``stats()["vetoes"]`` and in ``serve.decode.veto.*``.

Observability, as the JAX engine's (``raydp_tpu/serve/decode.py``): the
``serve.decode.*`` counters, gauges and histograms, ``serve.ttft_ms`` /
``serve.tpot_ms`` (and ``tenant.<ns>.serve.{ttft,tpot}_ms`` with a
``tenant``), created once at construction; per-token SLO judging into
goodput; for a stream submitted with a ``trace_ctx`` (a sampled stream's
``(trace_id, root_span_id)``, ``obs.mint_context()``), a
``serve.decode.prefill`` span under its root and one ``serve.decode.step``
fan-in span per round that carried a sampled stream, parented under the
first and listing all of them (emitted while tracing is on); about once a
second a ``serve.decode.state`` note (in-flight streams, queue depth, the
page pool) in the flight recorder's log ring, which a crash dossier's
decode section is built from; ``obs.flush_throttled()`` after each step.

The windows on the card. The device runs behind the host, and a window
ends for real only at a host sync: the prefill's ``int(torch.argmax(...))``
and the step's ``.tolist()`` of the next tokens. So ``prefill_s`` (and the
``serve.decode.prefill_s`` histogram, which adds the KV append and the
first emit) covers the prefill forward's device work; ``kv_alloc_s``
covers the *launch* of the page appends, whose device work completes at
the next step's sync and is charged there; ``serve.decode.step_s`` (and
``token_ms``, per rider) covers the gather, the step's forward through its
sync, and the launch of its appends. TTFT and the TPOT gaps are stamped at
emits, each after a sync, so they are what a client sees. The engine adds
no sync for the sake of obs.

The engine's ``tenant`` also labels its cache's
``tenant.<ns>.serve.kv.bytes`` gauge (``serve/kvcache.py``).

Everything runs eagerly on the engine's device under
``torch.inference_mode()``, in the engine's own loop thread.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raydp_tpu_torch import obs
from raydp_tpu_torch._device import resolve_device
from raydp_tpu_torch.obs import metrics
from raydp_tpu_torch.obs import tracing as _tracing
from raydp_tpu_torch.obs.profiler import current_mem_pressure
from raydp_tpu_torch.obs.recorder import note_log
from raydp_tpu_torch.serve.kvcache import PagedKVCache

_PAD_SEQ = "_pad"

# retired-stream timing records kept for explain()
_RECORD_KEEP = 64


@dataclass
class _Stream:
    stream_id: str
    prompt: List[int]
    max_new_tokens: int
    t_submit: float
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    t_first: Optional[float] = None
    # a sampled stream's (trace_id, root_span_id), minted by the caller:
    # the engine's spans parent under the root
    ctx: Optional[Tuple[str, str]] = None
    # lifecycle stamps + phase accumulators behind explain()
    t_admit: Optional[float] = None  # popped from pending -> prefill starts
    t_last: Optional[float] = None  # previous token's emit (TPOT gaps)
    t_done: Optional[float] = None  # last token emitted
    prefill_s: float = 0.0  # prefill compute
    kv_alloc_s: float = 0.0  # cache alloc + page-warm appends
    step_compute_s: float = 0.0  # decode-round walls while in a slot
    churn_s: float = 0.0  # other streams' admissions while in a slot
    steps: int = 0
    good_tokens: int = 0
    late_tokens: int = 0


class DecodeEngine:
    """One process-local continuous-batching loop over a ``TransformerLM``.

    The model holds its own weights (the JAX engine takes ``params``
    beside the model). ``device`` defaults to CUDA and must be where the
    model lives; pass ``device="cpu"`` with a CPU model to run the plain
    paths. ``model`` should use ``attn_impl="flash"``, the kernel family
    ``flash_decode`` shares its k-tiling with.
    """

    def __init__(
        self,
        model,
        *,
        capacity_tokens: int = 512,
        page_tokens: int = 128,
        max_seqs: int = 4,
        max_new_tokens: int = 64,
        int8_kv: bool = False,
        eos_token: Optional[int] = None,
        max_mem_pressure: float = 0.95,
        ttft_slo_ms: Optional[float] = None,
        tpot_slo_ms: Optional[float] = None,
        tenant: str = "",
        device=None,
    ):
        self.device = resolve_device(device)
        if model.device.type != self.device.type or (
            self.device.index is not None and model.device != self.device
        ):
            raise ValueError(
                f"model is on {model.device}, engine on {self.device}"
            )
        if capacity_tokens > model.max_len:
            raise ValueError(
                f"capacity_tokens {capacity_tokens} exceeds the model's "
                f"max_len {model.max_len}"
            )
        self._model = model
        self.capacity_tokens = int(capacity_tokens)
        self.max_seqs = int(max_seqs)
        self.max_new_tokens_cap = int(max_new_tokens)
        self.int8_kv = bool(int8_kv)
        self.eos_token = eos_token
        self.max_mem_pressure = float(max_mem_pressure)
        # per-token deadline tracking (serve.decode.goodput): first token
        # against ttft_slo_ms, token k against t_first + (k-1)*tpot_slo_ms
        # (cumulative -- a slow step makes every later token late until the
        # engine catches up)
        self.ttft_slo_ms = float(ttft_slo_ms) if ttft_slo_ms else None
        self.tpot_slo_ms = float(tpot_slo_ms) if tpot_slo_ms else None
        self.tenant = str(tenant or "")

        head_dim = model.d_model // model.num_heads
        self._cache = PagedKVCache(
            layers=model.num_layers,
            heads=model.num_heads,
            head_dim=head_dim,
            capacity_tokens=self.capacity_tokens,
            page_tokens=int(page_tokens),
            max_seqs=self.max_seqs + 1,  # + the pad sequence's page
            int8=self.int8_kv,
            device=self.device,
            tenant=self.tenant,
        )
        self._cache.alloc(_PAD_SEQ)
        zero = torch.zeros((model.num_layers, model.num_heads, 1, head_dim))
        self._cache.append(_PAD_SEQ, zero, zero)

        self._lock = threading.Lock()
        # guarded-by: self._lock
        self._pending: deque = deque()
        self._streams: Dict[str, _Stream] = {}
        self._slots: List[Optional[str]] = [None] * self.max_seqs
        self._ids = itertools.count()
        self._closed = False
        self._wake = threading.Event()
        self._records: "OrderedDict[str, dict]" = OrderedDict()
        self._last_record: Optional[dict] = None
        # engine-local tallies for stats(): the metric counters below are
        # process-global and would conflate engines
        self._good_total = 0
        self._late_total = 0
        self._veto_counts = {"kv_pages": 0, "slots": 0, "mem_pressure": 0}
        self._prefills = 0
        self._steps = 0
        self._last_state_note = 0.0
        # end of the previous decode round: riders are charged the whole
        # round-to-round wall, reset at each admission (that window is churn)
        self._round_anchor: Optional[float] = None

        self._m_tokens = metrics.counter("serve.decode.tokens")
        self._m_steps = metrics.counter("serve.decode.steps")
        self._m_prefills = metrics.counter("serve.decode.prefills")
        self._m_vetoed = metrics.counter("serve.decode.admission_vetoed")
        # veto causes, split so "why is my stream queued" has a metric
        self._m_veto_kv = metrics.counter("serve.decode.veto.kv_pages")
        self._m_veto_slots = metrics.counter("serve.decode.veto.slots")
        self._m_veto_mem = metrics.counter("serve.decode.veto.mem_pressure")
        self._m_good = metrics.counter("serve.decode.good_tokens")
        self._m_late = metrics.counter("serve.decode.late_tokens")
        self._g_goodput = metrics.gauge("serve.decode.goodput")
        self._g_inflight = metrics.gauge("serve.decode.inflight")
        self._g_queued = metrics.gauge("serve.decode.queued")
        self._h_fill = metrics.histogram("serve.decode.batch_fill")
        self._h_step = metrics.histogram("serve.decode.step_s")
        self._h_ttft = metrics.histogram("serve.ttft_ms")
        self._h_prefill = metrics.histogram("serve.decode.prefill_s")
        self._h_token = metrics.histogram("serve.decode.token_ms")
        self._h_tpot = metrics.histogram("serve.tpot_ms")
        # tenant.<ns>.* histograms become tenant-labelled series in the
        # time-series mirror (obs/timeseries.py split_labels)
        self._h_ttft_tenant = (
            metrics.histogram(f"tenant.{self.tenant}.serve.ttft_ms")
            if self.tenant else None
        )
        self._h_tpot_tenant = (
            metrics.histogram(f"tenant.{self.tenant}.serve.tpot_ms")
            if self.tenant else None
        )

        self._thread = threading.Thread(
            target=self._loop, name="serve-decode", daemon=True
        )
        self._thread.start()

    # -- client surface ------------------------------------------------

    def submit(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: int,
        stream_id: Optional[str] = None,
        trace_ctx: Optional[Tuple[str, str]] = None,
    ) -> str:
        """Queue a sequence; returns a stream id to ``poll``. The prompt
        must fit the cache with its worst-case continuation. ``trace_ctx``
        is a sampled stream's (trace_id, root_span_id), minted by the
        caller: the engine's prefill and step fan-in spans parent under
        it."""
        prompt = [int(t) for t in prompt_tokens]
        max_new = min(int(max_new_tokens), self.max_new_tokens_cap)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new > self.capacity_tokens:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"cache capacity {self.capacity_tokens}"
            )
        with self._lock:
            if self._closed:
                raise RuntimeError("decode engine closed")
            sid = stream_id or f"s{next(self._ids)}"
            if sid in self._streams:
                raise ValueError(f"stream {sid!r} already exists")
            stream = _Stream(sid, prompt, max_new, time.monotonic())
            if trace_ctx is not None:
                stream.ctx = (str(trace_ctx[0]), str(trace_ctx[1]))
            self._streams[sid] = stream
            self._pending.append(stream)
            self._g_queued.set(float(len(self._pending)))
        self._wake.set()
        return sid

    def poll(self, stream_id: str, cursor: int = 0) -> dict:
        """Tokens emitted at or after ``cursor`` plus terminal state."""
        with self._lock:
            stream = self._streams.get(stream_id)
            if stream is None:
                raise KeyError(f"unknown stream {stream_id!r}")
            out = {
                "tokens": list(stream.tokens[int(cursor):]),
                "done": stream.done,
                "error": stream.error,
            }
            if stream.done:
                # terminal poll retires the bookkeeping once drained
                if int(cursor) + len(out["tokens"]) >= len(stream.tokens):
                    self._streams.pop(stream_id, None)
        return out

    def generate(
        self, prompt_tokens: Sequence[int], max_new_tokens: int,
        timeout: float = 60.0,
    ) -> List[int]:
        """Blocking convenience wrapper: submit + drain one stream."""
        sid = self.submit(prompt_tokens, max_new_tokens)
        deadline = time.monotonic() + timeout
        tokens: List[int] = []
        while True:
            res = self.poll(sid, len(tokens))
            tokens.extend(res["tokens"])
            if res["error"]:
                raise RuntimeError(res["error"])
            if res["done"]:
                return tokens
            if time.monotonic() > deadline:
                raise TimeoutError(f"stream {sid} timed out")
            time.sleep(0.002)

    def stats(self) -> dict:
        with self._lock:
            judged = self._good_total + self._late_total
            return {
                "inflight": sum(1 for s in self._slots if s is not None),
                "queued": len(self._pending),
                "streams": len(self._streams),
                "kv_pages_free": self._cache.free_pages,
                "kv_pages_total": self._cache.pool_pages,
                "kv_bytes": self._cache.nbytes,
                "prefills": self._prefills,
                "steps": self._steps,
                "good_tokens": self._good_total,
                "late_tokens": self._late_total,
                "goodput": (
                    self._good_total / judged if judged else None
                ),
                "vetoes": dict(self._veto_counts),
            }

    def explain(self, stream_id: Optional[str] = None) -> Optional[dict]:
        """The engine-kept timing record of one retired stream (default:
        the most recently retired); None when no stream has retired or the
        id aged out of the bounded record window."""
        with self._lock:
            if stream_id is None:
                rec = self._last_record
            else:
                rec = self._records.get(stream_id)
            return dict(rec) if rec is not None else None

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for stream in self._streams.values():
                if not stream.done:
                    stream.done = True
                    stream.error = "decode engine closed"
                    self._retire_locked(stream)
            self._pending.clear()
        self._wake.set()
        self._thread.join(timeout=10.0)
        self._cache.close()
        self._g_inflight.set(0.0)
        self._g_queued.set(0.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- engine loop ---------------------------------------------------

    def _loop(self) -> None:
        on_device = (
            torch.cuda.device(self.device) if self.device.type == "cuda"
            else contextlib.nullcontext()
        )
        with on_device, torch.inference_mode():
            while True:
                with self._lock:
                    if self._closed:
                        return
                try:
                    worked = self._admit()
                    worked = self._step() or worked
                    self._note_state_throttled()
                except Exception as exc:  # noqa: BLE001 - the loop must not die silently
                    obs.log.warning("decode engine step failed", exc_info=True)
                    self._fail_all(exc)
                    return
                if not worked:
                    self._wake.wait(0.005)
                    self._wake.clear()

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            for stream in self._streams.values():
                if not stream.done:
                    stream.done = True
                    stream.error = f"{type(exc).__name__}: {exc}"
                    self._retire_locked(stream)
            self._pending.clear()
            self._slots = [None] * self.max_seqs
            self._g_inflight.set(0.0)

    def _admit(self) -> bool:
        """Move pending sequences into free slots: prefill their prompt at
        the fixed [1, capacity] shape, warm their KV pages, and emit the
        first token. Vetoed (not failed) while the page pool, the batch or
        host memory pressure says no."""
        admitted = False
        while True:
            with self._lock:
                if not self._pending:
                    break
                try:
                    slot = self._slots.index(None)
                except ValueError:  # a full batch: admission resumes when a stream retires
                    self._m_veto_slots.inc()
                    self._veto_counts["slots"] += 1
                    break
                stream = self._pending[0]
                worst_case = len(stream.prompt) + stream.max_new_tokens
                if not self._cache.can_admit(worst_case):
                    self._m_vetoed.inc()
                    self._m_veto_kv.inc()
                    self._veto_counts["kv_pages"] += 1
                    break
                self._pending.popleft()
                self._g_queued.set(float(len(self._pending)))
            if current_mem_pressure() > self.max_mem_pressure:
                # put it back and stop admitting until pressure drains
                with self._lock:
                    self._pending.appendleft(stream)
                    self._g_queued.set(float(len(self._pending)))
                    self._veto_counts["mem_pressure"] += 1
                self._m_vetoed.inc()
                self._m_veto_mem.inc()
                break

            t0 = time.perf_counter()
            stream.t_admit = time.monotonic()
            length = len(stream.prompt)
            toks = torch.zeros((1, self.capacity_tokens), dtype=torch.int64)
            toks[0, :length] = torch.as_tensor(stream.prompt)
            logits, new_kv = self._model(toks.to(self.device), return_kv=True)
            first = int(torch.argmax(logits[0, length - 1]))
            stream.prefill_s = time.perf_counter() - t0
            t_alloc = time.perf_counter()
            self._cache.alloc(stream.stream_id)
            k_rows = torch.stack([k[0, :, :length] for k, _ in new_kv])
            v_rows = torch.stack([v[0, :, :length] for _, v in new_kv])
            self._cache.append(stream.stream_id, k_rows, v_rows)
            stream.kv_alloc_s = time.perf_counter() - t_alloc
            with self._lock:
                self._prefills += 1
            self._m_prefills.inc()
            self._emit(stream, first, slot=slot)
            admit_s = time.perf_counter() - t0
            self._h_prefill.observe(admit_s)
            with self._lock:
                # streams already decoding stalled for this admission's
                # whole window: the "admission churn" phase of their
                # time-per-token decomposition
                for sid in self._slots:
                    if sid is None or sid == stream.stream_id:
                        continue
                    other = self._streams.get(sid)
                    if other is not None:
                        other.churn_s += admit_s
                self._round_anchor = time.perf_counter()
            if stream.ctx is not None and _tracing.enabled():
                now_wall_us = time.time_ns() // 1000
                _tracing.record_span(
                    "serve.decode.prefill",
                    now_wall_us - int(admit_s * 1e6), int(admit_s * 1e6),
                    trace=stream.ctx[0], parent=stream.ctx[1],
                    stream=stream.stream_id, prompt_tokens=length,
                    queue_s=round(stream.t_admit - stream.t_submit, 6),
                    prefill_s=round(stream.prefill_s, 6),
                    kv_alloc_s=round(stream.kv_alloc_s, 6),
                )
            admitted = True
        return admitted

    def _emit(self, stream: _Stream, token: int, slot: Optional[int] = None) -> None:
        now = time.monotonic()
        with self._lock:
            stream.tokens.append(int(token))
            n_tok = len(stream.tokens)
            if stream.t_first is None:
                stream.t_first = now
                ttft_ms = (now - stream.t_submit) * 1000.0
                self._h_ttft.observe(ttft_ms)
                if self._h_ttft_tenant is not None:
                    self._h_ttft_tenant.observe(ttft_ms)
                on_time = (
                    self.ttft_slo_ms is None or ttft_ms <= self.ttft_slo_ms
                )
            else:
                tpot_ms = (now - (stream.t_last or stream.t_first)) * 1000.0
                self._h_tpot.observe(tpot_ms)
                if self._h_tpot_tenant is not None:
                    self._h_tpot_tenant.observe(tpot_ms)
                # cumulative deadline: token k due at t_first + (k-1)*TPOT
                on_time = self.tpot_slo_ms is None or (
                    (now - stream.t_first) * 1000.0
                    <= (n_tok - 1) * self.tpot_slo_ms
                )
            stream.t_last = now
            if self.ttft_slo_ms is not None or self.tpot_slo_ms is not None:
                if on_time:
                    stream.good_tokens += 1
                    self._good_total += 1
                    self._m_good.inc()
                else:
                    stream.late_tokens += 1
                    self._late_total += 1
                    self._m_late.inc()
                judged = self._good_total + self._late_total
                self._g_goodput.set(self._good_total / float(judged))
            self._m_tokens.inc()
            finished = (
                len(stream.tokens) >= stream.max_new_tokens
                or (self.eos_token is not None and token == self.eos_token)
            )
            if finished:
                stream.done = True
                stream.t_done = now
                self._retire_locked(stream)
                if slot is None and stream.stream_id in self._slots:
                    slot = self._slots.index(stream.stream_id)
                if slot is not None and self._slots[slot] == stream.stream_id:
                    self._slots[slot] = None
                self._cache.free(stream.stream_id)
            elif slot is not None:
                self._slots[slot] = stream.stream_id
            self._g_inflight.set(
                float(sum(1 for s in self._slots if s is not None))
            )

    def _retire_locked(self, stream: _Stream) -> None:
        """Fold a finished/failed stream's stamps into a bounded record that
        ``explain`` can fetch after the stream's bookkeeping is gone.
        Caller holds ``self._lock``."""
        t_first = stream.t_first
        t_done = stream.t_done if stream.t_done is not None else stream.t_last
        rec = {
            "stream_id": stream.stream_id,
            "prompt_tokens": len(stream.prompt),
            "tokens": len(stream.tokens),
            "steps": stream.steps,
            "error": stream.error,
            "trace": stream.ctx[0] if stream.ctx else None,
            "queue_s": max(
                0.0, (stream.t_admit or stream.t_submit) - stream.t_submit
            ),
            "prefill_s": stream.prefill_s,
            "kv_alloc_s": stream.kv_alloc_s,
            "step_compute_s": stream.step_compute_s,
            "churn_s": stream.churn_s,
            "ttft_s": (
                max(0.0, t_first - stream.t_submit)
                if t_first is not None else None
            ),
            "steady_s": (
                max(0.0, t_done - t_first)
                if t_first is not None and t_done is not None else None
            ),
            "wall_s": (
                max(0.0, t_done - stream.t_submit)
                if t_done is not None else None
            ),
            "good_tokens": stream.good_tokens,
            "late_tokens": stream.late_tokens,
        }
        self._records[stream.stream_id] = rec
        self._last_record = rec
        while len(self._records) > _RECORD_KEEP:
            self._records.popitem(last=False)

    def _note_state_throttled(self, min_interval: float = 1.0) -> None:
        """Drop a structured decode-state record into the process's flight
        ring (about once a second, tracing on or off): the in-flight
        streams with their tokens emitted and KV lengths, the queue depth
        and the page pool, which a crash dossier's decode section is built
        from (obs/recorder.py)."""
        now = time.monotonic()
        if now - self._last_state_note < min_interval:
            return
        self._last_state_note = now
        with self._lock:
            inflight = {}
            for sid in self._slots:
                if sid is None:
                    continue
                stream = self._streams.get(sid)
                if stream is None:
                    continue
                try:
                    kv_len = self._cache.length(sid)
                except KeyError:
                    kv_len = 0
                inflight[sid] = {
                    "emitted": len(stream.tokens), "kv_len": kv_len,
                    "prompt": len(stream.prompt),
                }
            state = {
                "inflight": inflight,
                "queued": len(self._pending),
                "pages": {
                    "free": self._cache.free_pages,
                    "total": self._cache.pool_pages,
                    "page_tokens": self._cache.page_tokens,
                },
            }
        note_log("INFO", _tracing.process_role(), "serve.decode.state", state)

    def _step(self) -> bool:
        """One continuous-batching decode iteration over every occupied
        slot, at the fixed [max_seqs, 1] shape (pad slots masked out)."""
        with self._lock:
            slots = list(self._slots)
            active = [
                (i, self._streams[sid])
                for i, sid in enumerate(slots) if sid is not None
            ]
        if not active:
            return False

        t0 = time.perf_counter()
        seq_ids = [sid if sid is not None else _PAD_SEQ for sid in slots]
        toks = np.zeros((self.max_seqs, 1), np.int64)
        kv_len = np.ones(self.max_seqs, np.int32)
        for i, stream in active:
            toks[i, 0] = stream.tokens[-1]
            kv_len[i] = self._cache.length(stream.stream_id) + 1

        gathered = self._cache.gather(seq_ids)
        if self.int8_kv:
            k8, ks, v8, vs = gathered
            caches = [
                (k8[ly], ks[ly], v8[ly], vs[ly]) for ly in range(k8.shape[0])
            ]
        else:
            k, v = gathered
            caches = [(k[ly], v[ly]) for ly in range(k.shape[0])]

        logits, new_kv = self._model(
            torch.as_tensor(toks, device=self.device),
            kv_caches=caches,
            kv_len=torch.as_tensor(kv_len, device=self.device),
        )
        next_tokens = torch.argmax(logits[:, -1], dim=-1).tolist()

        for i, stream in active:
            k_rows = torch.stack([k[i] for k, _ in new_kv])
            v_rows = torch.stack([v[i] for _, v in new_kv])
            self._cache.append(stream.stream_id, k_rows, v_rows)
            self._emit(stream, next_tokens[i])

        t_end = time.perf_counter()
        step_s = t_end - t0
        # riders are charged the round-to-round wall: with active streams
        # the loop runs back to back, so anchor -> end covers the step plus
        # the previous round's bookkeeping
        anchor = self._round_anchor
        round_s = t_end - anchor if anchor is not None and anchor <= t0 \
            else step_s
        round_s = max(round_s, step_s)
        self._round_anchor = t_end
        self._m_steps.inc()
        self._h_step.observe(step_s)
        self._h_fill.observe(len(active) / float(self.max_seqs))
        self._h_token.observe(step_s * 1000.0 / len(active))
        with self._lock:
            self._steps += 1
            for _, stream in active:
                stream.step_compute_s += round_s
                stream.steps += 1
        sampled = [s for _, s in active if s.ctx is not None]
        if sampled and _tracing.enabled():
            # one fan-in span per round linking the sampled streams riding
            # this batch: parented under the first, listing all of them
            now_wall_us = time.time_ns() // 1000
            first = sampled[0]
            _tracing.record_span(
                "serve.decode.step",
                now_wall_us - int(step_s * 1e6), int(step_s * 1e6),
                trace=first.ctx[0], parent=first.ctx[1],
                streams=len(active), fill=len(active) / float(self.max_seqs),
                stream_spans=[s.ctx[1] for s in sampled],
                stream_traces=[s.ctx[0] for s in sampled],
            )
        obs.flush_throttled()
        return True
