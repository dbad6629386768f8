"""Krylov-basis store.

The reference archives every Lanczos block in a VRAM-budgeted resident
device buffer (gpu_buffer_size, RBL_gpu.jl:95-104) plus pinned host copies
for overflow (RBL_gpu.jl:168-169), and streams overflow blocks host→device
inside partial reorth (hybrid_part_reorth!, RBL_gpu.jl:59-81).

Two tiers, as in ``rbl_tpu/solver/basis.py``:

- **Device tier**: one zero-padded (n, capacity) buffer, preallocated at
  the solve's clamped Krylov cap, or at ``device_cap_cols`` when that is
  smaller (eager PyTorch has no recompiles to bound, so there is no
  geometric growth).  Blocks are written in place and the
  reorthogonalization contracts over the stored prefix ``view()``.
  Columns past the stored prefix stay zero: a rewind zeros what it
  discards.

- **Host tier** (opt-in via ``device_cap_cols``): when an append window
  does not fit under the cap, the store *compacts*: the oldest device
  columns move to one pinned-host panel and the newest shift to the
  buffer front.  One bulk panel copy per compaction instead of per-block
  streaming.  Panels keep global column order, so Ritz recovery is two
  contiguous GEMM groups (host panels, then the device tier) with no
  permutation.  On a CUDA device a panel is pinned memory, its
  device→host copy runs on a side stream, and the compaction that
  overwrites the copied columns waits for it; panels return to the
  device through two reused staging buffers (``stream_host_tier``), the
  next panel's copy overlapping the current panel's use.  A store on the
  CPU keeps its panels as plain tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy; sub-f32 storage upcasts to f32 (numpy has no
    portable bf16)."""
    t = t.detach()
    if t.dtype.itemsize < 4:
        t = t.float()
    return t.cpu().numpy()


class BasisStore:
    """Preallocated, zero-padded (n, capacity) basis buffer with an
    optional pinned-host overflow tier."""

    def __init__(self, n, block_size, max_cols, dtype, device,
                 device_cap_cols: Optional[int] = None):
        b = block_size
        self.n = n
        self.b = b
        self.max_cols = max_cols
        self.ncols = 0          # total stored columns (both tiers)
        self.dev_base = 0       # global column index of device column 0
        if device_cap_cols is not None:
            device_cap_cols = max((device_cap_cols // b) * b, 4 * b)
        self.device_cap_cols = device_cap_cols
        self.host_panels: list = []   # (n, w) host tensors, oldest first
        cols = max_cols if device_cap_cols is None else min(max_cols,
                                                            device_cap_cols)
        self.buf = torch.zeros((n, cols), dtype=dtype,
                               device=torch.device(device))
        self._cuda = self.buf.device.type == "cuda"
        self._side = None        # side stream of the panel copies
        self._panel_done = []    # per panel: event of its device→host copy
        self._stage = None       # two flat device staging buffers
        # traffic counters (bytes, panels), read by the solve's timer
        self.panels_written = 0
        self.d2h_bytes = 0
        self.h2d_bytes = 0

    # --- tier bookkeeping -------------------------------------------------

    @property
    def capacity(self):
        """Device-tier capacity (columns)."""
        return self.buf.shape[1]

    @property
    def dev_ncols(self):
        """Columns currently stored in the device tier."""
        return self.ncols - self.dev_base

    @property
    def host_ncols(self):
        return self.dev_base

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.buf.device)
        return self._side

    def _new_panel(self, width: int) -> torch.Tensor:
        # pinned on a CUDA store: a failed pin raises, it is not retried
        # in pageable memory
        return torch.empty((self.n, width), dtype=self.buf.dtype,
                           pin_memory=self._cuda)

    def _wait_panels(self) -> None:
        """Block the host until every panel's device→host copy is done
        (before the host reads or trims a panel)."""
        for ev in self._panel_done:
            if ev is not None:
                ev.synchronize()

    def _offload_oldest(self, keep_cols: int) -> None:
        """Move device cols [0, dev_ncols - keep_cols) to a host panel and
        shift the remainder to the buffer front."""
        dev_ncols = self.dev_ncols
        shift = dev_ncols - keep_cols
        panel = self._new_panel(shift)
        done = None
        if self._cuda:
            cur = torch.cuda.current_stream(self.buf.device)
            side = self._side_stream()
            side.wait_stream(cur)  # the columns' writers come first
            with torch.cuda.stream(side):
                panel.copy_(self.buf[:, :shift], non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            # the compaction below overwrites the columns being copied:
            # it must not start before the copy has read them
            cur.wait_event(done)
        else:
            panel.copy_(self.buf[:, :shift])
        self.host_panels.append(panel)
        self._panel_done.append(done)
        self.panels_written += 1
        self.d2h_bytes += panel.numel() * panel.element_size()
        moved = self.buf[:, shift:dev_ncols].clone()
        self.buf[:, :keep_cols].copy_(moved)
        self.buf[:, keep_cols:dev_ncols].zero_()
        self.dev_base += shift

    def _ensure(self, needed_total: int) -> None:
        """Make room in the device tier for ``needed_total`` total columns."""
        needed_dev = needed_total - self.dev_base
        cap = self.device_cap_cols
        if cap is not None and needed_dev > cap:
            # Compact, keeping as much of the newest history as fits next
            # to the incoming append window W.  keep = cap − W guarantees
            # one offload always suffices, and the feasibility check keeps
            # ≥ W + 2b columns resident so breakdown rewinds / Q_i
            # re-reads and the speculated chunk's own offload never touch
            # host-tier territory.
            W = needed_total - self.ncols
            if cap < 2 * W + 2 * self.b:
                raise ValueError(
                    f"basis_device_cap_cols={cap} too small for an append "
                    f"window of {W} columns (needs ≥ {2 * W + 2 * self.b}: "
                    "raise the cap or lower eig_poll_cadence·block_size)"
                )
            keep = (cap - W) // self.b * self.b
            self._offload_oldest(keep)

    # --- API ----------------------------------------------------------------

    def append(self, block) -> None:
        self._ensure(self.ncols + self.b)
        c = self.ncols - self.dev_base
        self.buf[:, c : c + self.b].copy_(block)
        self.ncols += self.b

    def view(self):
        """The device tier's stored prefix (n, dev_ncols) — a view, not a
        copy.  With a host tier these are the global columns
        [dev_base, ncols)."""
        return self.buf[:, : self.dev_ncols]

    def read_block(self, col: int, width: int):
        """A copy of the (n, width) block at GLOBAL column ``col``,
        whichever tier it lives in (a host panel's block re-enters the
        device).  A copy: a later rewind zeros the buffer in place."""
        if col + width > self.ncols:
            raise IndexError(f"columns {col}..{col + width} beyond stored {self.ncols}")
        if col >= self.dev_base:
            c = col - self.dev_base
            return self.buf[:, c : c + width].clone()
        base = 0
        for i, panel in enumerate(self.host_panels):
            w = panel.shape[1]
            if col < base + w:
                assert col - base + width <= w, "block straddles panels"
                if self._panel_done[i] is not None:
                    self._panel_done[i].synchronize()
                blk = panel[:, col - base : col - base + width]
                self.h2d_bytes += blk.numel() * blk.element_size()
                return blk.to(self.buf.device).contiguous()
            base += w
        raise IndexError(f"column {col} beyond stored range")

    def rewind(self, ncols_new: int) -> None:
        """Discard (and zero) every column ≥ ncols_new (speculation /
        breakdown / stale convergence-poll rewind), dropping or trimming
        host panels when the target predates the device tier."""
        if self.ncols <= ncols_new:
            return
        if ncols_new >= self.dev_base:
            self.buf[:, ncols_new - self.dev_base : self.dev_ncols].zero_()
            self.ncols = ncols_new
            return
        # target predates the device tier: the kept prefix lives entirely
        # in host panels — drop/trim panels, empty the device tier
        self._wait_panels()
        dev_ncols = self.dev_ncols
        while self.dev_base > ncols_new and self.host_panels:
            panel = self.host_panels.pop()
            self._panel_done.pop()
            self.dev_base -= panel.shape[1]
            if self.dev_base < ncols_new:
                keep_w = ncols_new - self.dev_base
                trimmed = self._new_panel(keep_w)
                trimmed.copy_(panel[:, :keep_w])
                self.host_panels.append(trimmed)
                self._panel_done.append(None)
                self.dev_base += keep_w
        self.buf[:, :dev_ncols].zero_()
        self.ncols = ncols_new

    def host_tier(self):
        """The host overflow panels, oldest first (may be empty)."""
        return self.host_panels

    def stream_host_tier(self):
        """Yield every host panel as a device tensor, oldest first.

        On a CUDA store each panel is copied into one of two reused
        staging buffers on the side stream, the next panel's copy queued
        before the current panel is handed out, so that it overlaps the
        consumer's work on the current one.  A yielded tensor is valid
        until the panel after the next is fetched: consume it at once."""
        panels = self.host_panels
        if not panels:
            return
        if not self._cuda:
            for p in panels:
                self.h2d_bytes += p.numel() * p.element_size()
                yield p
            return
        dev = self.buf.device
        cur = torch.cuda.current_stream(dev)
        side = self._side_stream()
        need = self.n * max(p.shape[1] for p in panels)
        if self._stage is None or self._stage[0].numel() < need:
            self._stage = [torch.empty(need, dtype=self.buf.dtype, device=dev)
                           for _ in range(2)]

        def fetch(i):
            p = panels[i]
            dst = self._stage[i % 2][: p.numel()].view(p.shape)
            # the slot's previous consumer was queued on the current
            # stream before this call; the panel's own device→host copy
            # ran on the side stream already
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                dst.copy_(p, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            self.h2d_bytes += p.numel() * p.element_size()
            return dst, ev

        nxt = fetch(0)
        for i in range(len(panels)):
            dst, ev = nxt
            if i + 1 < len(panels):
                nxt = fetch(i + 1)
            cur.wait_event(ev)
            yield dst

    def snapshot(self, ncols: int) -> np.ndarray:
        """The first ``ncols`` stored columns as one host numpy array
        (assembled across both tiers) — the sweep-checkpoint payload
        (utils/checkpoint.py).  Sub-f32 storage upcasts to f32; resume
        casts back.  Synchronises: the copy is read on the host."""
        assert ncols <= self.ncols, (ncols, self.ncols)
        self._wait_panels()
        parts = []
        got = 0
        for panel in self.host_panels:
            if got >= ncols:
                break
            w = min(panel.shape[1], ncols - got)
            parts.append(_to_numpy(panel[:, :w]))
            got += w
        if got < ncols:
            parts.append(_to_numpy(self.buf[:, : ncols - got]))
        if not parts:
            return np.zeros((self.n, 0), dtype=_to_numpy(self.buf[:0, :0]).dtype)
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)

    def load_snapshot(self, basis) -> None:
        """Refill an EMPTY store from a ``snapshot`` array, re-applying the
        dtype and the host-offload policy block by block."""
        assert self.ncols == 0, "load_snapshot requires a fresh store"
        basis = torch.from_numpy(np.ascontiguousarray(np.asarray(basis)))
        basis = basis.to(device=self.buf.device, dtype=self.buf.dtype)
        for c in range(0, basis.shape[1], self.b):
            self.append(basis[:, c : c + self.b])

    def reset(self):
        self._wait_panels()
        self.buf.zero_()
        self.ncols = 0
        self.dev_base = 0
        self.host_panels = []
        self._panel_done = []
