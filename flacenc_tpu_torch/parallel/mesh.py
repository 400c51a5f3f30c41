"""Batch-axis mesh for block encoding (port of ``flacenc_tpu/parallel/mesh.py``).

Frame-level data parallelism (reference: worker threads over crossbeam
channels, ``src/par.rs:109-193``) maps to splitting the block-batch axis of
every `(B, ...)` input into equal contiguous shards, one per mesh device,
each run by its own `BatchEncoder` replica. Blocks are independent, so the
hot path needs no collectives; the one cross-device reduction (total bits,
for progress reporting) is two plain sums.

A mesh may name the same device more than once: that is how a machine with
one card, or the CPU, exercises the split. A mesh that names a card that is
not visible raises (`device.resolve_device`).
"""

from __future__ import annotations

import concurrent.futures
import copy
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import name_card, on_card, resolve_device, timed_upload

BLOCK_AXIS = "blocks"


class BlockMesh:
    """A 1-D mesh with axis `BLOCK_AXIS`: the devices the batch axis is
    split over, in shard order."""

    axis_names = (BLOCK_AXIS,)

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(resolve_device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"BlockMesh({[str(d) for d in self.devices]})"


def block_mesh(devices: Optional[Sequence] = None) -> BlockMesh:
    """1-D mesh over every visible CUDA device, or over `devices` (names or
    `torch.device`s, repeats allowed); axis name "blocks"."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "block_mesh() spans the visible CUDA devices and there are none; "
                "pass devices=['cpu', ...] to build a CPU mesh"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    return BlockMesh(devices)


class ShardedEncoder:
    """One replica per mesh device: a copy of a `BatchEncoder` on it
    (`shard_encoder_fn`), or any callable that runs the forward there, such
    as a program of ``models.batch_encoder``'s registry.

    `launch` splits every input's batch axis into equal contiguous shards,
    copies shard i to device i (asynchronously from pinned memory, on that
    card's default stream) and runs replica i on it there, for every shard
    before waiting on any; it returns the per-shard outputs, each on its
    device, with their batch slices (a `BatchRunner` calls it on its
    dispatch lane, each replica's lock held). Calling the object returns
    what the single-device module returns, in batch order, on the mesh's
    first device (the other cards' outputs read by peer copies). Over
    registry programs, `warm` queues every replica's warm on its shard on
    its own device's capture thread (so N cards capture at once) and
    `ready` resolves once all of them have run."""

    def __init__(self, replicas: Sequence, mesh: BlockMesh):
        if len(replicas) != mesh.size:
            raise ValueError(f"{len(replicas)} replicas for a {mesh.size}-device mesh")
        self.mesh = mesh
        self.replicas = list(replicas)
        self._ready: Optional[concurrent.futures.Future] = None

    @property
    def ready(self) -> concurrent.futures.Future:
        """Resolves once every replica's `ready` has (replicas that are
        registry programs): with the first replica's error, if any."""
        if self._ready is None:
            self._ready = _all_of([rep.ready for rep in self.replicas])
        return self._ready

    def warm(self, make_inputs) -> tuple:
        """Warm every replica on its shard of `make_inputs()` (the
        replicas' `warm`). Returns (`ready`, the replicas whose warm this
        call queued)."""
        n = self.mesh.size
        queued = []
        for i, rep in enumerate(self.replicas):
            def shard(i=i):
                inputs = make_inputs()
                per = inputs[0].shape[0] // n
                return [x[i * per:(i + 1) * per] for x in inputs]
            queued += rep.warm(shard)[1]
        return self.ready, queued

    def launch(self, *inputs: torch.Tensor) -> List[Tuple[slice, object]]:
        """Copy shard i of every input straight to device i and run replica
        i there, shard after shard, waiting on none. On a card both go on
        its default stream with it current (`device.on_card`), whichever
        card the calling thread has current, so shard i's copy is ordered
        before replica i's replay. Each shard's copy is timed on its card
        (`device.timed_upload`). A replica's error raises with a note
        naming its device."""
        n = self.mesh.size
        B = inputs[0].shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split evenly over a {n}-device mesh")
        per = B // n
        shards = []
        for i, (rep, dev) in enumerate(zip(self.replicas, self.mesh.devices)):
            sl = slice(i * per, (i + 1) * per)
            try:
                with on_card(dev):
                    parts = [x[sl] for x in inputs]
                    with timed_upload(dev, parts):
                        xs = [x.to(dev, non_blocking=True) for x in parts]
                    shards.append((sl, rep(*xs)))
            except BaseException as e:
                name_card(e, dev)
                raise
        return shards

    def __call__(self, *inputs: torch.Tensor):
        outs = [out for _, out in self.launch(*inputs)]
        dev0 = self.mesh.devices[0]

        def cat(parts):
            return torch.cat([p.to(dev0) for p in parts])

        first = outs[0]
        if isinstance(first, torch.Tensor):
            return cat(outs)
        fields = [cat(parts) for parts in zip(*outs)]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def _all_of(futures: Sequence[concurrent.futures.Future]) -> concurrent.futures.Future:
    """A future that resolves once all of `futures` have: with the first
    error among them in their order, else with None."""
    out: concurrent.futures.Future = concurrent.futures.Future()
    left = [len(futures)]
    lock = threading.Lock()

    def settled(_):
        with lock:
            left[0] -= 1
            if left[0]:
                return
        errors = [f.exception() for f in futures if f.exception() is not None]
        if errors:
            out.set_exception(errors[0])
        else:
            out.set_result(None)

    for f in futures:
        f.add_done_callback(settled)
    return out


def shard_encoder_fn(encoder: torch.nn.Module, mesh: BlockMesh) -> ShardedEncoder:
    """Wraps a single-device `BatchEncoder` into a batch-split one over
    `mesh`. Each shard runs the same program as the single device, so no
    collective appears in the hot path and the outputs are identical."""
    return ShardedEncoder([copy.deepcopy(encoder).to(d) for d in mesh.devices], mesh)


def total_bits_psum(sf_bits, mesh: BlockMesh) -> torch.Tensor:
    """Total subframe bits across the mesh: each shard's bits are summed on
    its own device, then the partials are added on the first device.

    `sf_bits` is one (B, C) tensor (split in batch order like `launch`
    splits it) or the per-shard tensors. Returns an int64 scalar tensor on
    the mesh's first device."""
    if isinstance(sf_bits, torch.Tensor):
        n = mesh.size
        if sf_bits.shape[0] % n:
            raise ValueError(
                f"batch {sf_bits.shape[0]} does not split evenly over a {n}-device mesh"
            )
        shards = list(torch.chunk(sf_bits, n, dim=0))
    else:
        shards = list(sf_bits)
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a {mesh.size}-device mesh")
    partials = [
        s.to(dev).to(torch.int64).sum() for s, dev in zip(shards, mesh.devices)
    ]
    dev0 = mesh.devices[0]
    return torch.stack([p.to(dev0) for p in partials]).sum()


def shard_corpus(paths: Sequence[str], n_hosts: int, host_id: int) -> list:
    """Deterministic multi-host corpus sharding: each host takes a strided
    shard of the file list (size-agnostic, deterministic, no coordination
    needed: files are independent) and runs ``parallel.encode_corpus`` on
    its local devices."""
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} is not in [0, {n_hosts})")
    return list(paths[host_id::n_hosts])


def _payload_tensors(payload) -> List[torch.Tensor]:
    """An upload wire's payload as CPU tensors (uint32 words as int32)."""
    return [torch.from_numpy(np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32 else a))
            for a in payload]


def _check_wire(cfg, blocks: np.ndarray, kind: str, m: BlockMesh) -> tuple:
    """Pack `blocks` with ``ops.upack.try_pack``, which must pick the `kind`
    wire, run that wire's decisions program over `m` and check every
    replica's rows against the unsplit module's. Returns the wire tuple."""
    from ..models import batch_encoder as be
    from ..ops import upack

    packed = upack.try_pack(blocks)
    if packed is None or packed[0][0] != kind:
        raise AssertionError(f"try_pack chose {packed and packed[0]}, not the {kind!r} wire")
    wire, payload = packed
    _, C, T = blocks.shape
    encoder = be.BatchEncoder(cfg, C, 16, T, packed_wire=wire)
    inputs = _payload_tensors(payload)
    with torch.inference_mode():
        one = encoder(*inputs)
        for sl, out in shard_encoder_fn(encoder, m).launch(*inputs):
            if not torch.equal(out.cpu(), one[sl]):
                raise AssertionError(f"a replica of the {wire} program differs from the "
                                     "unsplit module's rows")
    return wire


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """Runs the default program with residuals (``decisions_only=False``) at
    T = 256, B = 2·n over an n-replica mesh, and checks `total_bits_psum`
    against the plain sum of the gathered `sf_bits`. Then the programs of
    two upload wires over the same mesh: the rice wire (a cumsum of small
    steps, which ``ops.upack.try_pack`` packs as "r") and the mid/side wire
    (the same with correlated channels, packed as "m"); every replica's
    decisions must equal the unsplit module's rows.

    The mesh spans the first n devices of `device`'s type when that many
    are visible and `device` names no index, else `device` n times. Returns
    a summary dict (also printed)."""
    from .. import config
    from ..models import batch_encoder as be

    dev = resolve_device(device)
    if (dev.type == "cuda" and torch.device(device).index is None
            and torch.cuda.device_count() >= n_devices):
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    m = block_mesh(devices)

    T = 256  # a tiny block keeps the dry run fast; the program is the same
    B = 2 * n_devices
    encoder = be.BatchEncoder(config.Encoder(), 2, 16, T, decisions_only=False)
    sharded = shard_encoder_fn(encoder, m)
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(rng.integers(-(1 << 12), 1 << 12, (B, 2, T), dtype=np.int32))
    with torch.inference_mode():
        shards = sharded.launch(blocks)
        total = total_bits_psum([enc.sf_bits for _, enc in shards], m)
        gathered = torch.cat([enc.sf_bits.cpu() for _, enc in shards])
    total = int(total.item())
    plain = int(gathered.to(torch.int64).sum())
    if total <= 0 or total != plain:
        raise AssertionError(f"total_bits_psum gave {total}, the plain sum is {plain}")

    smooth = np.cumsum(rng.integers(-40, 41, (B, 2, T), dtype=np.int32), axis=-1).astype(np.int32)
    rice_wire = _check_wire(config.Encoder(), smooth, "r", m)
    corr = smooth.copy()
    corr[:, 1] = corr[:, 0] + rng.integers(-8, 9, (B, T), dtype=np.int32)
    ms_wire = _check_wire(config.Encoder(), corr, "m", m)
    summary = {
        "devices": [str(d) for d in m.devices], "batch": B, "block_size": T,
        "total_bits": total, "wires": {"r": rice_wire, "m": ms_wire},
    }
    print(
        f"dryrun_multichip OK: {n_devices} replicas on {summary['devices']}, "
        f"batch {B}, total subframe bits {total}, rice wire {rice_wire} sharded OK, "
        f"ms wire {ms_wire} sharded OK"
    )
    return summary
