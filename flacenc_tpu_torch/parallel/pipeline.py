"""Corpus encoding on PyTorch (port of ``flacenc_tpu/parallel/pipeline.py``).

Blocks from many sources are streamed into shared `(B, C, T)` device
batches, so a corpus of short files keeps the card as busy as one long
stream:

- batches are grouped by sample rate (frame headers carry it); a bulk read
  that fills a whole batch while nothing of its rate is pending goes to the
  device as it is, other blocks queue per rate;
- every batch goes through the same `BatchRunner` as the stream entry, so
  at most two batches of raw PCM are held at once, plus one partial batch
  per rate;
- MD5 runs on a dedicated thread behind a bounded queue (par.rs:196-277),
  one digest per file;
- each file's ragged tail is encoded by the numpy oracle, and its frames
  are put back in order by frame number (the `ParSink` map, par.rs:67-95).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as config_mod
from ..component.datatype import Frame, Stream
from ..errors import Verified
from ..log import info_stats
from ..models import reference_encoder
from ..source import BoundedWorker, FrameBuf, Source, samples_to_le_bytes

# a module reference: the batch encoder imports this package in turn
from ..models import batch_encoder as be


@dataclasses.dataclass
class PipelineStats:
    """Counters of one corpus encode (the par.rs:414-421 analogue)."""

    files: int = 0
    frames: int = 0
    batches: int = 0
    read_s: float = 0.0         # time inside the sources' reads
    submit_s: float = 0.0       # pad, range check, strict arrays, upload, launch
    device_wait_s: float = 0.0  # host blocked on device results
    pack_s: float = 0.0         # host frame assembly (C++ packer)
    md5_wait_s: float = 0.0     # waiting on the MD5 thread at the end
    md5_overdue: int = 0        # producer stalls on the bounded MD5 queue
    tail_frames: int = 0


class _Md5Thread:
    """MD5 worker on the shared `source.BoundedWorker` (par.rs:196-277);
    stalls on its bounded queue surface as `stats.md5_overdue`."""

    def __init__(self, stats: PipelineStats):
        self._stats = stats
        self._worker = BoundedWorker(self._handle)

    @staticmethod
    def _handle(item):
        kind, h, payload, n, bytes_per = item
        if kind == 0:    # channel-major block: re-interleave first
            interleaved = np.ascontiguousarray(payload[:, :n].T).reshape(-1)
            h.update(samples_to_le_bytes(interleaved, bytes_per))
        elif kind == 1:  # interleaved samples (bulk path)
            h.update(samples_to_le_bytes(payload, bytes_per))
        else:            # raw little-endian PCM bytes (bulk WAV path)
            h.update(payload)

    def submit(self, h, samples: np.ndarray, n: int, bytes_per: int):
        self._worker.submit((0, h, samples, n, bytes_per))

    def submit_interleaved(self, h, samples: np.ndarray, bytes_per: int):
        self._worker.submit((1, h, samples, 0, bytes_per))

    def submit_bytes(self, h, data: bytes):
        self._worker.submit((2, h, data, 0, 0))

    def stop(self):
        """Drain the queue and join the worker; the overdue count is added
        to the stats once."""
        if not self._worker.stopped:
            self._worker.stop()
            self._stats.md5_overdue += self._worker.overdue

    def check(self):
        self._worker.check()


class _BulkHashCtx:
    """The context `Source.read_blocks_batch` fills: routes a bulk read's
    hash input to the `_Md5Thread` (raw WAV bytes hash as they are). Only
    the fill surface exists; the corpus loop counts samples itself."""

    def __init__(self, thread: _Md5Thread, h, bytes_per: int):
        self._thread = thread
        self._h = h
        self._bytes_per = bytes_per

    def fill_interleaved(self, a: np.ndarray, copy: bool = True, blocks: int = 1) -> None:
        if copy:
            a = np.array(a, dtype=np.int32, copy=True)
        self._thread.submit_interleaved(self._h, a, self._bytes_per)

    def fill_le_bytes(self, data: bytes, bytes_per: int, blocks: int = 1) -> None:
        self._thread.submit_bytes(self._h, bytes(data))


def encode_corpus(
    sources: Sequence[Tuple[str, Source]],
    config: Verified[config_mod.Encoder] | config_mod.Encoder,
    block_size: int,
    batch_size: int = 64,
    device: str | torch.device = "cuda",
    strict_lpc: Optional[bool] = None,
) -> Tuple[Dict[str, Stream], PipelineStats]:
    """Encode many sources through shared device batches.

    All sources must share channels and bits per sample; sample rates may
    differ. `device` and `strict_lpc` act as in `encode_with_fixed_block_
    size` (the same `resolve_strict` rule, the same `BatchRunner`). Each
    returned stream is byte-identical to the file encoded alone. Returns
    ({name: Stream}, PipelineStats)."""
    cfg = config.inner if isinstance(config, Verified) else config
    strict_lpc = be.resolve_strict(strict_lpc, cfg)
    stats = PipelineStats(files=len(sources))
    if not sources:
        return {}, stats

    nch = sources[0][1].channels()
    bps = sources[0][1].bits_per_sample()
    for name, src in sources:
        if (src.channels(), src.bits_per_sample()) != (nch, bps):
            raise ValueError(
                "corpus sources must share channel count and "
                f"bits-per-sample: {name!r} has "
                f"(channels={src.channels()}, bps={src.bits_per_sample()}) "
                f"vs (channels={nch}, bps={bps})"
            )
    bytes_per = -(-bps // 8)

    frames_by_file: List[Dict[int, Frame]] = [dict() for _ in sources]
    n_full = [0] * len(sources)
    tails: List[Optional[np.ndarray]] = [None] * len(sources)
    md5s = [hashlib.md5() for _ in sources]
    total_samples = [0] * len(sources)

    runner = be.BatchRunner(cfg, nch, bps, block_size, batch_size, device, strict_lpc)
    md5_thread = _Md5Thread(stats)
    # pending (file, frame number, block) rows per sample rate
    pending: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}

    def route(result):
        if result is not None:
            for (fi, bi), frame in zip(result.cookie, result.frames):
                frames_by_file[fi][bi] = frame

    def submit_pending(rate: int):
        items = pending.pop(rate)
        route(runner.submit(
            [it[2] for it in items], [it[1] for it in items], rate,
            cookie=[it[:2] for it in items],
        ))

    try:
        for fi, (name, src) in enumerate(sources):
            rate = src.sample_rate()
            framebuf = FrameBuf(nch, block_size)
            bulk_ctx = _BulkHashCtx(md5_thread, md5s[fi], bytes_per)
            while True:
                t0 = time.perf_counter()
                chunk = src.read_blocks_batch(batch_size, block_size, bulk_ctx)
                stats.read_s += time.perf_counter() - t0
                if chunk is None:
                    break
                k = chunk.shape[0]
                total_samples[fi] += k * block_size
                if k == batch_size and not pending.get(rate):
                    # aligned: the bulk chunk is one device batch as it is
                    bi0 = n_full[fi]
                    n_full[fi] += k
                    route(runner.submit(
                        chunk, np.arange(bi0, bi0 + k), rate,
                        cookie=[(fi, bi0 + i) for i in range(k)],
                    ))
                else:
                    for i in range(k):
                        pending.setdefault(rate, []).append((fi, n_full[fi], chunk[i]))
                        n_full[fi] += 1
                        if len(pending[rate]) == batch_size:
                            submit_pending(rate)
                if k < batch_size:
                    break
            while True:
                t0 = time.perf_counter()
                read = src.read_samples(block_size, framebuf)
                stats.read_s += time.perf_counter() - t0
                if read == 0:
                    break
                block = framebuf.samples[:, :read].copy()
                total_samples[fi] += read
                md5_thread.submit(md5s[fi], block, read, bytes_per)
                if read < block_size:
                    tails[fi] = block  # a short read is the file's tail
                    break
                pending.setdefault(rate, []).append((fi, n_full[fi], block))
                n_full[fi] += 1
                if len(pending[rate]) == batch_size:
                    submit_pending(rate)
        for rate in list(pending):
            submit_pending(rate)
        for result in runner.drain():
            route(result)
    finally:
        t0 = time.perf_counter()
        md5_thread.stop()
        stats.md5_wait_s += time.perf_counter() - t0
    md5_thread.check()
    for key in ("submit_s", "device_wait_s", "pack_s", "batches"):
        setattr(stats, key, runner.stats[key])

    results: Dict[str, Stream] = {}
    for fi, (name, src) in enumerate(sources):
        stream = Stream(src.sample_rate(), nch, bps)
        for i in range(n_full[fi]):
            stream.add_frame(frames_by_file[fi][i])
        if tails[fi] is not None:
            tail = tails[fi]
            fb = FrameBuf(nch, tail.shape[1])
            fb.fill_interleaved(np.ascontiguousarray(tail.T).reshape(-1))
            stream.add_frame(reference_encoder.encode_fixed_size_frame(
                cfg, fb, n_full[fi], stream.stream_info(), strict_lpc=strict_lpc,
            ))
            stats.tail_frames += 1
        stats.frames += stream.frame_count()
        if stream.frame_count() > 0:
            mx = stream.stream_info().max_block_size
            stream.stream_info_mut().set_block_sizes(mx, mx)
        stream.stream_info_mut().set_md5_digest(md5s[fi].digest())
        hint = src.len_hint()
        stream.stream_info_mut().set_total_samples(
            hint if hint is not None else total_samples[fi]
        )
        results[name] = stream

    info_stats(event="corpus_encode", **dataclasses.asdict(stats))
    return results, stats
