"""The check against a broken program: a run of a cell on the CPU, with
the encoder broken underneath, comes out not correct, once for each fault
that the cell can have."""

import json

import pytest

from benchmark.test_bench_rehearsal import four_device_checkout, last_line, run_cell

FAULTS = {
    # every call answered with the stream of the call before it
    "state_unchanged": """
from flacenc_tpu_torch.models import batch_encoder as be
_orig = be.encode_with_fixed_block_size
_last = []
def _stale(*args, **kwargs):
    out = _orig(*args, **kwargs)
    _last.append(out)
    return _last[-2] if len(_last) > 1 else out
be.encode_with_fixed_block_size = _stale
""",
    # the second half of every batch's frames left out: the first half's
    # stand in for them
    "half_batch_left_out": """
from flacenc_tpu_torch.models import batch_encoder as be
_orig = be._assemble_frames
def _half(*args):
    frames = _orig(*args)
    h = len(frames) // 2
    return frames[:len(frames) - h] + frames[:h]
be._assemble_frames = _half
""",
    # one bit of every frame altered where the host pack writes it
    "answer_altered": """
from flacenc_tpu_torch.models import batch_encoder as be
_orig = be._assemble_frames
def _altered(*args):
    frames = _orig(*args)
    for f in frames:
        b = bytearray(f.precomputed_bitstream)
        b[len(b) // 2] ^= 0x04
        f.precomputed_bitstream = bytes(b)
    return frames
be._assemble_frames = _altered
""",
}

EXCHANGE = """
import torch
from flacenc_tpu_torch.parallel import mesh as pmesh
_orig = pmesh.ShardedEncoder.launch
def _no_exchange(self, *inputs):
    shards = _orig(self, *inputs)
    # the last device never gets its shard: it encodes zeros in its place
    sl, _ = shards[-1]
    zeros = [torch.zeros_like(x[sl]).to(self.mesh.devices[-1]) for x in inputs]
    return shards[:-1] + [(sl, self.replicas[-1](*zeros))]
pmesh.ShardedEncoder.launch = _no_exchange
"""


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    line = last_line(run_cell("cd_default_1card.album", 0, FAULTS[fault]))
    assert line["correct"] is False, json.dumps(line["checks"])


def test_exchange_between_cards_left_out_is_not_correct(tmp_path):
    line = last_line(run_cell("cd_default_4card.album", 0, EXCHANGE,
                              **four_device_checkout(tmp_path)))
    assert line["correct"] is False, json.dumps(line["checks"])


def test_sound_run_is_correct():
    assert last_line(run_cell("cd_default_1card.album", 0, seed=77))["correct"] is True
