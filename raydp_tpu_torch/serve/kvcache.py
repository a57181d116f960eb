"""Paged KV cache for incremental decode: the counterpart of
``raydp_tpu/serve/kvcache.py``.

One device tensor holds a pool of fixed-size pages; each sequence owns a
block table (list of page ids) and a valid length. Decode steps ``append``
the newest K/V rows and ``gather`` dense per-layer [B, H, Tcap, D] tensors
for ``ops.flash_decode`` -- positions at or past a sequence's length hold
whatever the pool holds and are never read by the kernel, which stops at
``kv_len``.

The JAX package keeps the pool in a shared-memory arena of its block store,
watched by the memory-watermark plane and owner-GC'd by the head; the port
has no store yet, so the pool is one tensor on the engine's device and
``gather`` is an index-select there.

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

        # [layer, k/v, page, token, head, dim]: token-major rows inside a
        # page, so a page is a contiguous run of quantization rows
        self._vals = torch.zeros(
            (layers, 2, self.pool_pages, page_tokens, heads, head_dim),
            dtype=torch.int8 if int8 else torch.float32, device=self.device,
        )
        self._scales = (
            torch.zeros(
                (layers, 2, self.pool_pages, page_tokens, heads),
                dtype=torch.float32, device=self.device,
            ) if int8 else None
        )
        self.nbytes = self._vals.nbytes + (
            self._scales.nbytes if int8 else 0
        )

        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.pool_pages))
        self._tables: Dict[str, List[int]] = {}
        self._lengths: Dict[str, int] = {}
        self._closed = False

    # -- bookkeeping --------------------------------------------------------

    def alloc(self, seq_id: str) -> None:
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id!r} already allocated")
            self._tables[seq_id] = []
            self._lengths[seq_id] = 0

    def free(self, seq_id: str) -> None:
        with self._lock:
            pages = self._tables.pop(seq_id, [])
            self._lengths.pop(seq_id, None)
            self._free.extend(pages)

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

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
