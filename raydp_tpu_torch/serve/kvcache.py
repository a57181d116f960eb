"""Paged KV cache for incremental decode: the counterpart of
``raydp_tpu/serve/kvcache.py``.

A pool of fixed-size pages; each sequence owns a block table (list of page
ids) and a valid length. Decode steps ``append`` the newest K/V rows and
``gather`` dense per-layer [B, H, Tcap, D] tensors for ``ops.flash_decode``
-- positions at or past a sequence's length hold whatever the pool holds
and are never read by the kernel, which stops at ``kv_len``.

Where the pool lives depends on the device:

- on CUDA it is one device tensor, which the decode kernels read in place
  (a host arena would add a pool-sized upload to every step);
- on the CPU it is a shared-memory arena of the port's store
  (``store.create_block(storage="shm")``, ``rtpt-`` prefix), viewed as
  tensors with ``torch.frombuffer``, as the JAX package keeps its pool:
  ``mem.shm_bytes`` / ``mem.pressure`` see every page the moment the arena
  is created, the arena is registered with the head under the current
  owner (the replica actor in serving), so the head's owner-GC unlinks it
  when that actor is SIGKILLed, and the leak audit fails shutdown if an
  arena outlives its engine. Device memory needs none of that: it dies
  with the process.

Either way the ``serve.kv.*`` gauges (bytes, pages total and free,
sequences, page occupancy, fragmentation, used bytes) follow every alloc,
append and free, with ``tenant.<ns>.serve.kv.bytes`` for a named tenant,
and ``close`` zeroes them.

Optional int8 mode stores quantized K/V values plus per-row (per position,
per head) f32 scales from ``ops.quantization.quantize_int8``; the decode
kernel dequantizes on the fly. f32 mode is exact -- the mode the
decode == prefill determinism contract is stated for.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from raydp_tpu_torch._device import resolve_device
from raydp_tpu_torch.obs import metrics
from raydp_tpu_torch.ops.quantization import quantize_int8

DEFAULT_PAGE_TOKENS = 128


class KVCacheFull(RuntimeError):
    """No free pages -- the admission controller should defer, not crash."""


class PagedKVCache:
    """Page-pool KV cache with per-sequence block tables.

    layers/heads/head_dim: model geometry (one pool spans all layers).
    capacity_tokens: per-sequence maximum length (multiple of page_tokens);
        the fixed cache shape the decode step runs at.
    max_seqs: sizes the default pool (``max_seqs`` full-length sequences).
    int8: store int8 values + per-row f32 scales instead of f32 values.
    device: where the pool lives (CUDA unless ``"cpu"`` is asked for).
    tenant: names the ``tenant.<ns>.serve.kv.bytes`` gauge.
    """

    def __init__(
        self,
        *,
        layers: int,
        heads: int,
        head_dim: int,
        capacity_tokens: int,
        page_tokens: int = DEFAULT_PAGE_TOKENS,
        max_seqs: int = 8,
        pool_pages: int | None = None,
        int8: bool = False,
        device=None,
        tenant: str = "",
    ):
        if capacity_tokens % page_tokens:
            raise ValueError(
                f"capacity_tokens {capacity_tokens} must be a multiple of "
                f"page_tokens {page_tokens}"
            )
        self.device = resolve_device(device)
        self.layers = layers
        self.heads = heads
        self.head_dim = head_dim
        self.capacity_tokens = capacity_tokens
        self.page_tokens = page_tokens
        self.pages_per_seq = capacity_tokens // page_tokens
        self.pool_pages = pool_pages or max_seqs * self.pages_per_seq
        self.int8 = int8
        self.tenant = str(tenant or "")

        # [layer, k/v, page, token, head, dim]: token-major rows inside a
        # page, so a page is a contiguous run of quantization rows
        val_shape = (layers, 2, self.pool_pages, page_tokens, heads, head_dim)
        scale_shape = val_shape[:-1]
        val_dtype = torch.int8 if int8 else torch.float32
        self._block = None
        self._ref = None
        if self.device.type == "cuda":
            self._vals = torch.zeros(val_shape, dtype=val_dtype,
                                     device=self.device)
            self._scales = (
                torch.zeros(scale_shape, dtype=torch.float32,
                            device=self.device) if int8 else None
            )
        else:
            self._vals, self._scales = self._arena(
                val_shape, val_dtype, scale_shape if int8 else None)
        self.nbytes = self._vals.nbytes + (
            self._scales.nbytes if int8 else 0
        )

        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.pool_pages))
        self._tables: Dict[str, List[int]] = {}
        self._lengths: Dict[str, int] = {}
        self._closed = False
        metrics.gauge("serve.kv.bytes").set_watermark(float(self.nbytes))
        metrics.gauge("serve.kv.pages_total").set(float(self.pool_pages))
        self._update_gauges()

    def _arena(self, val_shape, val_dtype, scale_shape):
        """The CPU pool: one store block holding the values, then the
        scales, viewed as tensors. Registered with the head under the
        current owner (an explicit owner: the block-service handoff must
        never adopt the arena, which would then outlive its replica).
        Best effort -- a standalone cache (tests, the driver) has no head;
        there ``close``'s abort and the leak audit cover it."""
        from raydp_tpu_torch.store.object_store import (
            ObjectRef, _register, create_block, current_owner,
        )

        itemsize = torch.empty((), dtype=val_dtype).element_size()
        n_vals = int(np.prod(val_shape))
        n_scales = int(np.prod(scale_shape)) if scale_shape else 0
        val_bytes = n_vals * itemsize
        total = val_bytes + 4 * n_scales
        self._block = create_block(total, storage="shm")
        try:
            ref = ObjectRef(self._block.object_id, total)
            _register(ref, current_owner())
            self._ref = ref
        except Exception:  # no cluster: a standalone cache cleans up through abort()
            self._ref = None
        view = self._block.writable_view()
        vals = torch.frombuffer(view, dtype=val_dtype, count=n_vals)
        scales = None
        if scale_shape:
            scales = torch.frombuffer(
                view, dtype=torch.float32, count=n_scales, offset=val_bytes
            ).view(scale_shape)
        return vals.view(val_shape), scales

    # -- bookkeeping --------------------------------------------------------

    def _update_gauges(self) -> None:
        metrics.gauge("serve.kv.pages_free").set(float(len(self._free)))
        metrics.gauge("serve.kv.seqs").set(float(len(self._tables)))
        # occupancy is the page pool's fill; fragmentation is the share of
        # allocated token slots no live position occupies (pages are
        # fixed-size, so a 1-token tail page is mostly waste)
        used = self.pool_pages - len(self._free)
        metrics.gauge("serve.kv.page_occupancy").set(
            used / float(self.pool_pages) if self.pool_pages else 0.0
        )
        allocated_tokens = used * self.page_tokens
        live_tokens = sum(self._lengths.values())
        metrics.gauge("serve.kv.fragmentation").set(
            1.0 - live_tokens / float(allocated_tokens)
            if allocated_tokens else 0.0
        )
        used_bytes = (
            self.nbytes * (used / float(self.pool_pages))
            if self.pool_pages else 0.0
        )
        metrics.gauge("serve.kv.used_bytes").set(used_bytes)
        if self.tenant:
            # tenant.<ns>.* names become tenant-labelled series in the
            # time-series mirror (obs/timeseries.py split_labels)
            metrics.gauge(f"tenant.{self.tenant}.serve.kv.bytes").set(
                used_bytes
            )

    def alloc(self, seq_id: str) -> None:
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id!r} already allocated")
            self._tables[seq_id] = []
            self._lengths[seq_id] = 0
            self._update_gauges()

    def free(self, seq_id: str) -> None:
        with self._lock:
            pages = self._tables.pop(seq_id, [])
            self._lengths.pop(seq_id, None)
            self._free.extend(pages)
            self._update_gauges()

    def length(self, seq_id: str) -> int:
        return self._lengths[seq_id]

    def lengths(self, seq_ids: Sequence[str]) -> np.ndarray:
        return np.asarray([self._lengths[s] for s in seq_ids], np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_tokens)

    def can_admit(self, n_tokens: int) -> bool:
        return len(self._free) >= self.pages_needed(n_tokens)

    # -- data path ----------------------------------------------------------

    def append(self, seq_id: str, k_new, v_new) -> None:
        """Write the newest K/V rows. k_new/v_new: [layers, heads, t, dim]
        (tensors on any device, or numpy; stored as f32, or quantized in
        int8 mode). Grows the block table as pages fill; raises KVCacheFull
        when the pool is dry (the caller defers admission -- in-flight
        sequences always have their pages already)."""
        t = k_new.shape[2]
        with self._lock:
            table = self._tables[seq_id]
            start = self._lengths[seq_id]
            if start + t > self.capacity_tokens:
                raise ValueError(
                    f"sequence {seq_id!r} would exceed capacity "
                    f"{self.capacity_tokens} ({start}+{t})"
                )
            need = self.pages_needed(start + t) - len(table)
            if need > len(self._free):
                raise KVCacheFull(
                    f"need {need} pages, {len(self._free)} free"
                )
            for _ in range(need):
                table.append(self._free.pop())
            self._lengths[seq_id] = start + t
            self._update_gauges()
            pos = np.arange(start, start + t)
            pages = np.asarray(table, np.int64)[pos // self.page_tokens]
            rows = pages * self.page_tokens + pos % self.page_tokens

        idx = torch.as_tensor(rows, device=self.device)
        n_rows = self.pool_pages * self.page_tokens
        flat = self._vals.view(
            self.layers, 2, n_rows, self.heads, self.head_dim
        )
        for kv, new in enumerate((k_new, v_new)):
            # [layers, heads, t, dim] -> token-major [layers, t, heads, dim]
            x = torch.as_tensor(new, device=self.device).float().transpose(1, 2)
            if self.int8:
                vals, scales = quantize_int8(x.reshape(-1, self.head_dim))
                x = vals.reshape(self.layers, t, self.heads, self.head_dim)
                self._scales.view(self.layers, 2, n_rows, self.heads)[
                    :, kv
                ].index_copy_(1, idx, scales.reshape(self.layers, t, self.heads))
            flat[:, kv].index_copy_(1, idx, x)

    def gather(self, seq_ids: Sequence[str]):
        """Dense per-layer cache tensors for a decode batch, on the device.

        f32 mode: (k, v) each [layers, B, heads, Tcap, dim] float32.
        int8 mode: (k, k_scale, v, v_scale) -- values int8, scales
        [layers, B, heads, Tcap] float32.

        Pages past a sequence's table are page 0: the decode kernel stops
        at ``kv_len`` and never reads them."""
        with self._lock:
            tables = []
            for s in seq_ids:
                table = self._tables[s]
                tables.append(table + [0] * (self.pages_per_seq - len(table)))
        page_ids = torch.as_tensor(tables, dtype=torch.int64, device=self.device)
        bsz = len(seq_ids)
        # [layers, 2, B, pages, page_tokens, heads, dim]
        vals = self._vals[:, :, page_ids].reshape(
            self.layers, 2, bsz, self.capacity_tokens, self.heads,
            self.head_dim,
        ).transpose(3, 4)  # [layers, 2, B, heads, Tcap, dim]
        k, v = vals[:, 0].contiguous(), vals[:, 1].contiguous()
        if not self.int8:
            return k, v
        sc = self._scales[:, :, page_ids].reshape(
            self.layers, 2, bsz, self.capacity_tokens, self.heads
        ).transpose(3, 4)  # [layers, 2, B, heads, Tcap]
        return k, sc[:, 0].contiguous(), v, sc[:, 1].contiguous()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._vals = None
        self._scales = None
        if self._ref is not None:
            # graceful retirement: drop the head's ownership record first
            # so the owner-GC has nothing left to do when the actor exits
            from raydp_tpu_torch.store.object_store import delete

            try:
                delete([self._ref])
            except Exception:  # the head is already gone at teardown: its shutdown unlinked the segment
                pass
            self._ref = None
        if self._block is not None:
            self._block.abort()
            self._block = None
        for name in ("bytes", "pages_total", "pages_free", "seqs",
                     "page_occupancy", "fragmentation", "used_bytes"):
            metrics.gauge(f"serve.kv.{name}").set(0.0)
        if self.tenant:
            metrics.gauge(f"tenant.{self.tenant}.serve.kv.bytes").set(0.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
