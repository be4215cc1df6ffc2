"""Device-resident payload pool — the kernel-retained skb pages, kept on
the fast side of the boundary (one resident int32 ``torch.Tensor``).

Libra's premise is that payloads are written once into the kernel-retained
pool and never touched again. The legacy :class:`~repro_torch.core.stream.
TokenPool` honours that on the host but betrays it at the device boundary:
every batched device round re-uploads the whole pool (``astype(int32)``)
and syncs the touched rows back — two O(pool) crossings per scheduling
round, exactly the "bulk data crosses the boundary" failure mode the paper
eliminates (and the regime kernel-resident L7 datapaths like XLB win in).

:class:`DevicePool` keeps the ``[P+1, page]`` pool **resident as one
int32 tensor on** ``device`` **across rounds**: the anchoring kernels
write it in place, the egress gather reads it in place, and only O(batch) data
(the round's stream/tables/keystreams up, the gathered payloads down) ever
crosses the boundary. The host ``int64`` mirror inherited from
``TokenPool`` stays available for the scalar datapaths and the tests via
**dirty-row tracking**:

* ``host-dirty`` rows — host truth, device copy stale/unfaithful. Set by
  scalar-path writes (``write_payload``/``write_payload_batch``) and for
  rows whose int64 content does not survive the int32 device dtype.
  Uploaded lazily (O(rows)) when a device round touches them; a round that
  would need an out-of-range row raises :class:`DeviceRangeError` so the
  caller can bounce that round to the int64-exact host path.
* ``device-dirty`` rows — device truth, host mirror stale. Set by device
  anchoring rounds. Materialized lazily (O(rows)) when a host read/write
  or a whole-pool view (``data``/``flat_with_scratch``) needs them.

Every boundary crossing is counted in :attr:`TokenPool.xfer`
(``h2d_tokens``/``d2h_tokens``); ``pool_syncs`` — the O(pool) crossing
counter — stays at zero for this class by construction, and the batched-
datapath tests assert it.

Residency is lazy: a host-only stack never touches the device. With
``device="cuda"`` and no GPU present, the first device round raises; it
never carries on on the CPU.

:attr:`DevicePool.fused_buffers` is the ring depth the stack passes to
every fused round (``n_buffers``). In the port 0 means the kernel's
default depth (``DEFAULT_FUSED_DEPTH`` in
:mod:`repro_torch.kernels.selective_copy`), not the TPU kernel's blocked
layout; 2 and up is that many ring slots, and 1 or a negative value
raises ``ValueError`` from the round.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.anchor_pool import AnchorPool, PageRef
from repro_torch.core.stream import TokenPool

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


class DeviceRangeError(Exception):
    """A round needs pool rows / operands whose int64 values do not survive
    the int32 device dtype — serve it from the int64-exact host path."""


class DevicePool(TokenPool):
    """A :class:`TokenPool` whose batched device rounds run against one
    resident int32 tensor on ``device`` instead of per-round whole-pool
    bounces."""

    def __init__(self, alloc: AnchorPool, device="cuda"):
        super().__init__(alloc, device=device)
        self._dev = None                      # torch.Tensor [P+1, page] int32
        rows = self._flat.shape[0]
        self._host_dirty = np.zeros((rows,), bool)
        self._dev_dirty = np.zeros((rows,), bool)
        # batched egress rounds asked of the device plane but gathered on
        # the host (int32-range bounce, non-contiguous page list)
        self.xfer["host_gathers"] = 0
        # DMA staging ring depth for the fused one-kernel round (0 = the
        # kernel's default depth); set from kernels.dma_profile.
        # auto_buffer_depth or the LIBRA_FUSED_BUFFERS env var by the
        # deployment
        self.fused_buffers = 0

    # -- residency -----------------------------------------------------------
    @property
    def resident(self) -> bool:
        """True once the device copy exists (first device round)."""
        return self._dev is not None

    def dirty_rows(self) -> np.ndarray:
        """Rows whose truth currently lives on the device (host mirror
        stale) — telemetry/testing hook."""
        return np.flatnonzero(self._dev_dirty)

    def _ensure_device(self) -> None:
        """Create the resident device pool from the host mirror — ONE
        O(pool) upload for the lifetime of the pool, not one per round.
        Rows whose int64 content does not fit int32 stay host-truth."""
        if self._dev is not None:
            return
        dev = self.torch_device()             # raises: no GPU behind "cuda"
        flat = self._flat
        oob = ((flat < I32_MIN) | (flat > I32_MAX)).any(axis=1)
        self._host_dirty |= oob
        self._dev = torch.from_numpy(flat.astype(np.int32)).to(dev)
        self.xfer["resident_init_tokens"] += flat.size

    def _upload_rows(self, rows: np.ndarray) -> None:
        """Make ``rows`` faithful on the device (host-dirty rows go up,
        O(rows) not O(pool)). Raises :class:`DeviceRangeError` — before
        touching anything — when a row's content cannot survive int32."""
        sel = rows[self._host_dirty[rows]]
        if len(sel) == 0:
            return
        vals = self._flat[sel]
        if vals.size and (vals.min() < I32_MIN or vals.max() > I32_MAX):
            raise DeviceRangeError("host-truth rows exceed int32")
        self._dev[self._index(sel)] = self._upload(vals)   # in place
        self._host_dirty[sel] = False
        self.xfer["h2d_tokens"] += vals.size

    def _materialize_rows(self, rows: np.ndarray) -> None:
        """Pull device-truth ``rows`` back into the host mirror (lazy,
        O(rows)): int32 device values are exact in the int64 mirror."""
        sel = rows[self._dev_dirty[rows]]
        if len(sel) == 0:
            return
        host = self._dev[self._index(sel)].cpu().numpy().astype(np.int64)
        self._flat[sel] = host
        self._dev_dirty[sel] = False
        self.xfer["d2h_tokens"] += host.size

    def materialize(self) -> None:
        """Sync every device-truth row into the host mirror (tests and
        whole-pool consumers; scalar datapaths use the per-row lazy path)."""
        self._materialize_rows(np.arange(self._flat.shape[0]))

    def _rows_of(self, pages: Sequence[PageRef]) -> np.ndarray:
        return np.unique(np.fromiter(
            (self.alloc.flat_pid(pg) for pg in pages), np.int64,
            count=len(pages)))

    # -- host views materialize lazily ----------------------------------------
    # Both whole-pool views keep TokenPool's write-through contract: the
    # caller may mutate what they return. A write through the view cannot
    # be observed, so once resident the ENTIRE pool must be treated as
    # host-truth after handing one out — later device rounds lazily re-
    # upload whichever of those rows they actually touch (still O(rows)).
    @property
    def data(self) -> np.ndarray:
        self.materialize()
        if self._dev is not None:
            self._host_dirty[:] = True
        return self._data_view

    @property
    def flat_with_scratch(self) -> np.ndarray:
        self.materialize()
        if self._dev is not None:
            self._host_dirty[:] = True
        return self._flat

    # -- host (scalar-path) writes/reads keep the mirror authoritative --------
    def write_payload(self, pages: List[PageRef], payload: np.ndarray,
                      keystream: Optional[np.ndarray] = None) -> None:
        if self._dev is not None and pages and len(payload):
            rows = self._rows_of(pages)
            # a partial-page host write must land on the row's true content
            self._materialize_rows(rows)
            self._host_dirty[rows] = True
        super().write_payload(pages, payload, keystream=keystream)

    def write_payload_batch(self, seqs, keystreams=None) -> None:
        if self._dev is not None:
            all_pages = [pg for pages, p in seqs if len(p) and pages
                         for pg in pages]
            if all_pages:
                rows = self._rows_of(all_pages)
                self._materialize_rows(rows)
                self._host_dirty[rows] = True
        super().write_payload_batch(seqs, keystreams=keystreams)

    def read_payload(self, pages: List[PageRef], length: int,
                     keystream: Optional[np.ndarray] = None) -> np.ndarray:
        if self._dev is not None and pages and length:
            self._materialize_rows(self._rows_of(pages))
        return super().read_payload(pages, length, keystream=keystream)

    def read_payload_batch(self, seqs, keystreams=None):
        if self._dev is not None:
            all_pages = [pg for pages, ln in seqs if ln and pages
                         for pg in pages]
            if all_pages:
                self._materialize_rows(self._rows_of(all_pages))
        return super().read_payload_batch(seqs, keystreams=keystreams)


    def _index(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(rows, np.int64)).to(self._dev.device)

    def load_state(self, rows: np.ndarray,
                   host_dirty: Optional[np.ndarray] = None,
                   dev_dirty: Optional[np.ndarray] = None) -> None:
        """Make ``rows`` ([P+1, page], e.g. another implementation's
        resident pool as numpy) the resident device pool, and the host
        mirror agree with it. Dirty-row masks default to clean. Counts as
        the one-time residency upload."""
        rows = np.asarray(rows)
        if rows.shape != self._flat.shape:
            raise ValueError(f"pool rows {rows.shape}, expected "
                             f"{self._flat.shape}")
        self._flat[:] = rows.astype(np.int64)
        self._dev = torch.from_numpy(
            rows.astype(np.int32)).to(self.torch_device())
        n = self._flat.shape[0]
        self._host_dirty = (np.zeros((n,), bool) if host_dirty is None
                            else np.array(host_dirty, bool))
        self._dev_dirty = (np.zeros((n,), bool) if dev_dirty is None
                           else np.array(dev_dirty, bool))
        self.xfer["resident_init_tokens"] += rows.size

    # -- device data plane: resident, zero O(pool) crossings -------------------
    def _round_setup(self, tables: np.ndarray, *ops: Optional[np.ndarray]):
        """Residency + dirty-row upload for a round touching ``tables``'s
        rows, and the round's O(batch) operands as device tensors (None
        stays None). Returns ``(rows, tensors)``; may raise
        :class:`DeviceRangeError` before anything is launched."""
        self._ensure_device()
        rows = np.unique(tables[tables >= 0]).astype(np.int64)
        self._upload_rows(rows)               # may raise DeviceRangeError
        self.xfer["h2d_tokens"] += tables.size + sum(
            op.size for op in ops if op is not None)
        return rows, [None if op is None else self._upload(op)
                      for op in (tables, *ops)]

    def _note_round(self, ptr: int) -> None:
        """Round accounting. The kernels and the plain version both update
        the resident tensor in place, so the round keeps ONE pool buffer:
        ``donated_rounds`` counts rounds whose pool storage is unchanged
        (``data_ptr()``), which holds for every device round by
        construction."""
        if self._dev.data_ptr() == ptr:
            self.xfer["donated_rounds"] += 1
        self.xfer["device_rounds"] += 1

    def anchor_batch_device(self, stream: np.ndarray, meta_len: np.ndarray,
                            total_len: np.ndarray, tables: np.ndarray, *,
                            meta_max: int, impl: str,
                            keystream: Optional[np.ndarray] = None) -> None:
        """One batched ingress round, entirely on the device: upload
        O(batch) operands (plus any host-dirty rows the round overwrites),
        anchor into the resident pool in place, and keep it resident —
        **nothing O(pool) crosses the boundary, nothing syncs back**.
        Touched rows become device-truth (lazy host views)."""
        from repro_torch.kernels import ops

        rows, (tb, st, ml, tl, ks) = self._round_setup(
            tables, stream, meta_len, total_len, keystream)
        ptr = self._dev.data_ptr()
        _meta, self._dev = ops.selective_copy(
            st, ml, tl, self._dev, tb, meta_max=meta_max, impl=impl,
            keystream=ks)
        del _meta  # host buffers keep the int64-exact metadata
        self._note_round(ptr)
        self._dev_dirty[rows] = True
        self.xfer["anchor_rounds"] += 1

    def fused_round_device(
        self, stream: np.ndarray, meta_len: np.ndarray,
        total_len: np.ndarray, tables: np.ndarray, *, meta_max: int,
        impl: str, keystream: Optional[np.ndarray] = None,
        tx_keystream: Optional[np.ndarray] = None,
        cond_off: Optional[np.ndarray] = None,
        cond_lo: Optional[np.ndarray] = None,
        cond_hi: Optional[np.ndarray] = None,
        live: Optional[np.ndarray] = None,
        meta_ks: Optional[np.ndarray] = None,
        n_buffers: int = 0,
    ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """The **one-kernel scheduling round**: anchor + hw-kTLS keystream
        XOR + policy first-match + egress gather in a SINGLE launch against
        the resident pool — ``xfer['fused_rounds']`` counts exactly one
        ``device_rounds`` bump where the multi-pass path pays three.
        Upload is O(batch) operands plus any host-dirty rows the round
        overwrites; only the verdict column and the gathered payload block
        come down. ``n_buffers`` is the kernel's ring depth (0: the
        default depth; 1 or negative: ``ValueError``).

        Returns ``(verdict [B] | None, gathered [B, pps*page] int64)``."""
        from repro_torch.kernels import ops

        rows, (tb, st, ml, tl, ks, txks, off, lo, hi, lv, mks) = \
            self._round_setup(tables, stream, meta_len, total_len, keystream,
                              tx_keystream, cond_off, cond_lo, cond_hi,
                              live, meta_ks)
        ptr = self._dev.data_ptr()
        _meta, self._dev, verdict, gathered = ops.fused_round(
            st, ml, tl, self._dev, tb, meta_max=meta_max, impl=impl,
            keystream=ks, tx_keystream=txks, cond_off=off, cond_lo=lo,
            cond_hi=hi, live=lv, meta_ks=mks, n_buffers=n_buffers)
        del _meta  # host buffers keep the int64-exact metadata
        self._note_round(ptr)
        self._dev_dirty[rows] = True
        self.xfer["anchor_rounds"] += 1
        self.xfer["fused_rounds"] += 1
        host_out = gathered.cpu().numpy()
        self.xfer["d2h_tokens"] += host_out.size
        host_verdict = None
        if verdict is not None:
            host_verdict = verdict.cpu().numpy()
            self.xfer["d2h_tokens"] += host_verdict.size
        return host_verdict, host_out.astype(np.int64)

    def gather_batch_device(self, tables: np.ndarray, lengths: np.ndarray, *,
                            impl: str,
                            keystream: Optional[np.ndarray] = None,
                            ) -> np.ndarray:
        """One batched egress round: gather straight off the resident pool.
        Only the gathered payload block (O(batch)) comes down — the bytes
        that are leaving on the wire anyway."""
        from repro_torch.kernels import ops

        _rows, (tb, ln, ks) = self._round_setup(tables, lengths, keystream)
        ptr = self._dev.data_ptr()
        out = ops.selective_gather(self._dev, tb, ln, impl=impl,
                                   keystream=ks)
        host = out.cpu().numpy()
        self.xfer["d2h_tokens"] += host.size
        self._note_round(ptr)
        return host.astype(np.int64)
