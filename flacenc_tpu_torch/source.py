"""Input-source abstraction: Source, FrameBuf, MD5 Context.

Mirrors ``flacenc-rs/src/source.rs``. The MD5 context hashes the
little-endian PCM byte stream (``bytes_per_sample`` bytes per sample,
channel-interleaved), exactly like the reference's ``Context``
(source.rs:301-442). Byte conversion is vectorized with numpy; hashing uses
hashlib (C speed, releases the GIL so it overlaps device compute).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np

from .errors import SourceError, VerifyError


def verify_sample_range(samples: np.ndarray, bits_per_sample: int) -> None:
    """Range-check PCM against bps (source.rs:262-277); shared by FrameBuf
    and the batch pipeline."""
    if samples.dtype == np.int16 and bits_per_sample >= 16:
        return  # int16 storage is in range by construction
    lo = -(1 << (bits_per_sample - 1))
    hi = (1 << (bits_per_sample - 1)) - 1
    if samples.size and (int(samples.min()) < lo or int(samples.max()) > hi):
        raise VerifyError(
            "framebuf.samples",
            f"must be in range of {bits_per_sample}-bit signed ints",
        )


def samples_to_le_bytes(interleaved: np.ndarray, bytes_per_sample: int) -> bytes:
    """int32 samples -> little-endian packed bytes (1-4 bytes/sample)."""
    return bytes(_samples_le_view(interleaved, bytes_per_sample))


def _samples_le_view(interleaved: np.ndarray, bytes_per_sample: int):
    """Buffer with the little-endian PCM bytes of `interleaved`.

    Explicit '<' dtypes keep the layout platform-independent. The 1/2/4
    cases narrow in one numpy pass (the widths the MD5 context hashes per
    block — the old 4-byte-view-and-slice path cost 3.5x more). int16
    storage (the bps<=16 fast path) IS the wire layout for 2-byte
    samples — zero conversion on the hash path."""
    if interleaved.dtype == np.dtype("<i2"):
        if bytes_per_sample == 2:
            return np.ascontiguousarray(interleaved)
        if bytes_per_sample == 1:
            return interleaved.astype(np.int8)
    a = np.ascontiguousarray(interleaved, dtype="<i4")
    if bytes_per_sample == 4:
        return a
    if bytes_per_sample == 2:
        return a.astype("<i2")
    if bytes_per_sample == 1:
        return a.astype(np.int8)
    b = a.view(np.uint8).reshape(-1, 4)
    return np.ascontiguousarray(b[:, :bytes_per_sample])


def deinterleave_blocks(
    flat: np.ndarray, k: int, block_size: int, channels: int
) -> np.ndarray:
    """(k*T*C,) interleaved int32 -> (k, C, T) channel-major.

    Per-channel strided copies measured ~1.8x faster than
    `ascontiguousarray(reshape(k, T, C).transpose(0, 2, 1))` on the
    1-core bench host (~2.9 vs ~5.3 ms per 256x4096 stereo batch) — the
    deinterleave analogue of arrayutils.rs:140-264's SIMD kernels.

    The output keeps the input's dtype: int16 storage (the bps<=16 fast
    path) flows through at half the memory traffic; every consumer
    (device upload, wire scans, the C++ recompute packer) reads either
    dtype."""
    out = np.empty((k, channels, block_size), flat.dtype)
    r = flat.reshape(k, block_size, channels)
    for c in range(channels):
        out[:, c, :] = r[:, :, c]
    return out


def le_bytes_to_samples(data: bytes, bytes_per_sample: int) -> np.ndarray:
    """Little-endian PCM bytes -> int32 samples (sign-extended).

    Matches ``arrayutils::le_bytes_to_i32s`` (arrayutils.rs:273-364).
    """
    if bytes_per_sample == 2:
        return np.frombuffer(data, dtype="<i2").astype(np.int32)
    if bytes_per_sample == 1:
        return np.frombuffer(data, dtype=np.int8).astype(np.int32)
    if bytes_per_sample == 4:
        return np.frombuffer(data, dtype="<i4").astype(np.int32)
    if bytes_per_sample == 3:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        v = (
            raw[:, 0].astype(np.uint32)
            | (raw[:, 1].astype(np.uint32) << 8)
            | (raw[:, 2].astype(np.uint32) << 16)
        )
        v = v.astype(np.int32)
        return (v << 8) >> 8  # sign-extend from bit 23
    raise SourceError(SourceError.UNSUPPORTED_FORMAT)


class Context:
    """Streaming MD5 + sample/frame counters (source.rs:301-442)."""

    def __init__(self, bits_per_sample: int, channels: int) -> None:
        bytes_per_sample = -(-bits_per_sample // 8)
        if bytes_per_sample > 4:
            # the reference's panic message (source.rs via constant.rs)
            raise ValueError("bits_per_sample cannot be larger than 32.")
        self._md5 = hashlib.md5()
        self.bytes_per_sample = bytes_per_sample
        self.channels = channels
        self.sample_count = 0
        self.frame_count = 0

    def current_frame_number(self) -> Optional[int]:
        return self.frame_count - 1 if self.frame_count > 0 else None

    def md5_digest(self) -> bytes:
        return self._md5.copy().digest()

    def total_samples(self) -> int:
        return self.sample_count

    def fill_interleaved(self, interleaved: np.ndarray,
                         copy: bool = True, blocks: int = 1) -> None:
        # `copy` is part of the AsyncContext-compatible surface; the sync
        # context hashes synchronously so it never needs a snapshot.
        # `blocks` lets the bulk read paths (one fill per k-block batch)
        # keep frame_count in blocks, not batches.
        del copy
        if len(interleaved) == 0:
            return
        # hash the narrowed array's buffer directly — same bytes as
        # samples_to_le_bytes without materializing a bytes copy
        self._md5.update(_samples_le_view(interleaved, self.bytes_per_sample))
        self.sample_count += len(interleaved) // self.channels
        self.frame_count += blocks

    def fill_le_bytes(self, data: bytes, bytes_per_sample: int,
                      blocks: int = 1) -> None:
        if not data:
            return
        self._md5.update(data)
        self.sample_count += len(data) // self.channels // bytes_per_sample
        self.frame_count += blocks


class BoundedWorker:
    """Daemon worker draining a bounded queue (par.rs:196-277's channel
    discipline, shared by the stream and corpus MD5 pipelines).

    A handler exception is recorded and the queue keeps draining so
    producers never deadlock on the bound; `stop()` joins without raising
    (safe in `finally`), `check()` re-raises. Producer stalls on the full
    queue are counted in `overdue` (feeds the md5_overdue JSONL counter,
    par.rs:414-421)."""

    QUEUE_BOUND = 16  # par.rs:210 bounded(16) channel

    def __init__(self, handler) -> None:
        import queue as queue_mod
        import threading

        self._handler = handler
        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=self.QUEUE_BOUND)
        self._queue_mod = queue_mod
        self._error: Optional[BaseException] = None
        self.overdue = 0
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        import threading

        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, threading.Event):
                item.set()  # barrier marker — set even while error-draining
                continue
            if self._error is not None:
                continue  # keep draining so producers never block
            try:
                self._handler(item)
            except BaseException as e:  # re-raised by check()
                self._error = e

    def submit(self, item) -> None:
        if self._stopped:
            raise RuntimeError("BoundedWorker.submit after stop()")
        try:
            self._q.put_nowait(item)
        except self._queue_mod.Full:
            self.overdue += 1
            self._q.put(item)

    def barrier(self) -> None:
        """Blocks until every item submitted so far has been handled,
        WITHOUT stopping the worker (mid-stream digest reads)."""
        if self._stopped:
            return
        import threading

        ev = threading.Event()
        self._q.put(ev)
        ev.wait()

    @property
    def stopped(self) -> bool:
        return self._stopped

    def stop(self) -> None:
        """Drains the queue (FIFO) and joins; never raises. Idempotent."""
        if not self._stopped:
            self._stopped = True  # reject further submits immediately
            self._q.put(None)
            self._thread.join()

    def check(self) -> None:
        if self._error is not None:
            raise self._error


class AsyncContext:
    """`Context` whose hashing runs on a `BoundedWorker` — the stream-path
    analogue of the reference par mode's MD5 thread (par.rs:196-277).
    Exposes the same `Fill` surface INCLUDING the sync Context's
    read-then-continue contract: digest/counter reads barrier on the
    queue (all prior fills applied) but leave the worker running, so
    mid-stream progress queries work exactly like `Context` (which uses
    `md5.copy()` for the same reason). `worker.overdue` is the diagnostic
    stall counter."""

    def __init__(self, bits_per_sample: int, channels: int) -> None:
        self._inner = Context(bits_per_sample, channels)
        self.worker = BoundedWorker(self._handle)

    def _handle(self, item) -> None:
        kind, data, bytes_per, blocks = item
        if kind == 0:
            self._inner.fill_interleaved(data, blocks=blocks)
        else:
            self._inner.fill_le_bytes(data, bytes_per, blocks=blocks)

    def fill_interleaved(self, interleaved: np.ndarray,
                         copy: bool = True, blocks: int = 1) -> None:
        # snapshot: the caller may reuse/mutate its buffer after returning
        # (`copy=False` for stable buffers, e.g. MemSource slices — skips
        # a multi-MB copy per bulk batch). Keeps the input dtype: int16
        # storage hashes via the zero-conversion _samples_le_view path.
        if copy:
            interleaved = np.array(interleaved, copy=True)
        self.worker.submit((0, interleaved, 0, blocks))

    def fill_le_bytes(self, data: bytes, bytes_per_sample: int,
                      blocks: int = 1) -> None:
        self.worker.submit((1, bytes(data), bytes_per_sample, blocks))

    def _sync(self) -> None:
        """All prior fills applied; hashing errors re-raised; worker kept
        alive for further fills."""
        self.worker.barrier()
        self.worker.check()

    def finish(self) -> None:
        """Joins the worker; re-raises any hashing error."""
        self.worker.stop()
        self.worker.check()

    def shutdown(self) -> None:
        """Joins the worker without raising (safe in `finally`)."""
        self.worker.stop()

    def md5_digest(self) -> bytes:
        self._sync()
        return self._inner.md5_digest()

    def total_samples(self) -> int:
        self._sync()
        return self._inner.total_samples()

    def current_frame_number(self) -> Optional[int]:
        self._sync()
        return self._inner.current_frame_number()


class FrameBuf:
    """Channel-major reusable block buffer (source.rs:115-298)."""

    def __init__(self, channels: int, block_size: int) -> None:
        if block_size == 0:
            raise VerifyError("block_size", "must be nonzero")
        self.channels = channels
        self.block_size = block_size
        self.samples = np.zeros((channels, block_size), dtype=np.int32)
        self.filled = 0

    def size(self) -> int:
        return self.block_size

    def filled_size(self) -> int:
        return self.filled

    def channel_slice(self, ch: int) -> np.ndarray:
        return self.samples[ch, : self.filled]

    def fill_interleaved(self, interleaved: np.ndarray) -> None:
        interleaved = np.asarray(interleaved, dtype=np.int32)
        n = len(interleaved) // self.channels
        if n > self.block_size:
            raise SourceError(SourceError.INVALID_BUFFER)
        self.samples[:, :n] = interleaved[: n * self.channels].reshape(
            n, self.channels
        ).T
        if n < self.block_size:
            self.samples[:, n:] = 0
        self.filled = n

    def fill_le_bytes(self, data: bytes, bytes_per_sample: int) -> None:
        """Fill from little-endian PCM bytes (Fill trait, source.rs:42-111)."""
        self.fill_interleaved(le_bytes_to_samples(data, bytes_per_sample))

    def fill_stereo_with_iter(self, pairs) -> None:
        """Fill a stereo buffer from (ch0, ch1) pairs (source.rs:205)."""
        n = 0
        for i, (a, b) in enumerate(pairs):
            self.samples[0, i] = a
            self.samples[1, i] = b
            n = i + 1
        if n < self.block_size:
            self.samples[:, n:] = 0
        self.filled = n

    def verify_samples(self, bits_per_sample: int) -> None:
        """Range-check samples against bps (source.rs:262-277)."""
        verify_sample_range(self.samples[:, : self.filled], bits_per_sample)


class Source:
    """Abstract PCM input (source.rs:445-493)."""

    def channels(self) -> int:
        raise NotImplementedError

    def bits_per_sample(self) -> int:
        raise NotImplementedError

    def sample_rate(self) -> int:
        raise NotImplementedError

    def read_samples(self, block_size: int, dest: Tuple[FrameBuf, Context]) -> int:
        """Fill `dest` with up to `block_size` samples; returns count read."""
        raise NotImplementedError

    def read_blocks_batch(self, n_blocks: int, block_size: int,
                          context: Optional[Context]):
        """OPTIONAL bulk fast path for the batch encoder: up to `n_blocks`
        FULL blocks as one (k, channels, block_size) int32 channel-major
        array, hashing/counting into `context` with ONE call (per-block
        md5 updates + FrameBuf copies cost ~5 ms per 256-block batch on a
        single-core host). Returns None when unsupported — callers MUST
        fall back to per-block `read_samples` — else an array with
        k <= n_blocks (k < n_blocks only when no further full block
        exists; any remaining short tail is still read via
        `read_samples`)."""
        return None

    def len_hint(self) -> Optional[int]:
        return None


class Seekable(Source):
    """Seekable variant of `Source` (source.rs:499-538).

    Like the reference's trait, it is not used by the encoder today; it
    exists so future algorithms (multi-pass, random access) have the same
    contract. `__len__` returns per-channel samples."""

    def __len__(self) -> int:
        raise NotImplementedError

    def is_empty(self) -> bool:
        return len(self) == 0

    def seek_samples(self, n: int) -> None:
        raise NotImplementedError

    def read_samples_from(self, offset: int, block_size: int, dest) -> int:
        """Seek to `offset` (per-channel samples) and read one block."""
        self.seek_samples(offset)
        return self.read_samples(block_size, dest)


class MemSource(Seekable):
    """In-memory interleaved source (source.rs:543-639)."""

    def __init__(
        self,
        samples: np.ndarray,
        channels: int,
        bits_per_sample: int,
        sample_rate: int,
    ) -> None:
        arr = np.asarray(samples, dtype=np.int32)
        if bits_per_sample <= 16 and (
            arr.size == 0
            or (-32768 <= int(arr.min()) and int(arr.max()) <= 32767)
        ):
            # int16 storage fast path (bps<=16): halves every downstream
            # memory pass (deinterleave, upload, C++ recompute reads) and
            # makes the MD5 hash a zero-conversion view. Out-of-range
            # samples (vs int16) keep int32 so the per-block range check
            # still fires exactly where the reference's would
            # (source.rs:262-277) instead of silently wrapping here.
            arr = arr.astype(np.int16)
        self._samples = arr
        self._channels = channels
        self._bits_per_sample = bits_per_sample
        self._sample_rate = sample_rate
        self._offset = 0  # in inter-channel samples

    @staticmethod
    def from_samples(samples, channels, bits_per_sample, sample_rate) -> "MemSource":
        return MemSource(np.asarray(samples), channels, bits_per_sample, sample_rate)

    def channels(self) -> int:
        return self._channels

    def bits_per_sample(self) -> int:
        return self._bits_per_sample

    def sample_rate(self) -> int:
        return self._sample_rate

    def len_hint(self) -> Optional[int]:
        return len(self._samples) // self._channels

    def __len__(self) -> int:
        return len(self._samples) // self._channels

    def seek_samples(self, n: int) -> None:
        """Seekable analogue (source.rs:499-538)."""
        if not 0 <= n <= (len(self._samples) // self._channels):
            raise ValueError(f"seek_samples({n}) out of range")
        self._offset = n

    def read_samples(self, block_size: int, dest: Tuple[FrameBuf, Context]) -> int:
        framebuf, context = dest if isinstance(dest, tuple) else (dest, None)
        begin = self._offset * self._channels
        end = min(begin + block_size * self._channels, len(self._samples))
        chunk = self._samples[begin:end]
        if len(chunk) == 0:
            return 0
        framebuf.fill_interleaved(chunk)
        if context is not None:
            context.fill_interleaved(chunk)
        n = len(chunk) // self._channels
        self._offset += n
        return n

    def read_blocks_batch(self, n_blocks: int, block_size: int,
                          context: Optional[Context]):
        """Bulk fast path (see `Source.read_blocks_batch`): one md5 fill
        and one vectorized deinterleave per batch; the backing array is
        stable for the stream's lifetime, so the hash thread reads the
        slice without a snapshot copy."""
        C = self._channels
        begin = self._offset * C
        avail = (len(self._samples) - begin) // (block_size * C)
        k = min(n_blocks, avail)
        if k <= 0:
            return np.empty((0, C, block_size), self._samples.dtype)
        flat = self._samples[begin: begin + k * block_size * C]
        if context is not None:
            context.fill_interleaved(flat, copy=False, blocks=k)
        self._offset += k * block_size
        return deinterleave_blocks(flat, k, block_size, C)

    def interleaved(self) -> np.ndarray:
        return self._samples
