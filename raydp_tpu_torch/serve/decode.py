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

Determinism contract (docs/serving.md): with an f32 cache a decode step's
attention equals the prefill pass's row bit for bit (the kernel family in
``ops/flash_attention.py``), and sampling is greedy argmax.

Admission is exact page arithmetic: a sequence is admitted only when the
pool holds its worst case (prompt + max_new), so a step never dies on a
full pool. TTFT/TPOT SLO goodput is kept in the engine's own tallies. The
JAX engine's metrics, tracing spans, flight-recorder notes and
memory-pressure veto belong to the slice that ports the obs and store
layers.

Everything runs eagerly on the engine's device under
``torch.inference_mode()``, in the engine's own loop thread.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from raydp_tpu_torch._device import resolve_device
from raydp_tpu_torch.serve.kvcache import PagedKVCache

_log = logging.getLogger(__name__)

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
        ttft_slo_ms: Optional[float] = None,
        tpot_slo_ms: Optional[float] = None,
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
        # per-token deadline tracking: first token against ttft_slo_ms,
        # token k against t_first + (k-1)*tpot_slo_ms (cumulative -- a slow
        # step makes every later token late until the engine catches up)
        self.ttft_slo_ms = float(ttft_slo_ms) if ttft_slo_ms else None
        self.tpot_slo_ms = float(tpot_slo_ms) if tpot_slo_ms else None

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
        self._good_total = 0
        self._late_total = 0
        self._veto_counts = {"kv_pages": 0, "slots": 0}
        self._prefills = 0
        self._steps = 0
        # end of the previous decode round: riders are charged the whole
        # round-to-round wall, reset at each admission (that window is churn)
        self._round_anchor: Optional[float] = None

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
    ) -> str:
        """Queue a sequence; returns a stream id to ``poll``. The prompt
        must fit the cache with its worst-case continuation."""
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
            self._streams[sid] = stream
            self._pending.append(stream)
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
                except Exception as exc:  # noqa: BLE001 - the loop must not die silently
                    _log.warning("decode engine step failed", exc_info=True)
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

    def _admit(self) -> bool:
        """Move pending sequences into free slots: prefill their prompt at
        the fixed [1, capacity] shape, warm their KV pages, and emit the
        first token. Deferred (not failed) while the page pool says no."""
        admitted = False
        while True:
            with self._lock:
                if not self._pending:
                    break
                try:
                    slot = self._slots.index(None)
                except ValueError:  # a full batch: admission resumes when a stream retires
                    self._veto_counts["slots"] += 1
                    break
                stream = self._pending[0]
                worst_case = len(stream.prompt) + stream.max_new_tokens
                if not self._cache.can_admit(worst_case):
                    self._veto_counts["kv_pages"] += 1
                    break
                self._pending.popleft()

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
            self._emit(stream, first, slot=slot)
            admit_s = time.perf_counter() - t0
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
                on_time = (
                    self.ttft_slo_ms is None or ttft_ms <= self.ttft_slo_ms
                )
            else:
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
                else:
                    stream.late_tokens += 1
                    self._late_total += 1
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
        with self._lock:
            self._steps += 1
            for _, stream in active:
                stream.step_compute_s += round_s
                stream.steps += 1
        return True
