"""Component-tree (de)serialization — the reference's `serde` feature.

The reference derives Serialize/Deserialize for every component and the CLI
dumps streams as msgpack (``flacenc-bin/src/main.rs:301-316``); here every
component converts to/from plain dicts (JSON-able; arrays as lists), which
also serves as the encoder-result checkpoint format (a `Stream` can be
persisted losslessly and re-serialized to identical FLAC bytes).
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict

import numpy as np

from .datatype import (
    BlockSizeSpec,
    ChannelAssignment,
    Constant,
    FixedLpc,
    Frame,
    FrameHeader,
    Lpc,
    MetadataBlock,
    QuantizedParameters,
    Residual,
    SampleRateSpec,
    SampleSizeSpec,
    Stream,
    StreamInfo,
    Verbatim,
)


def _arr(a: np.ndarray) -> list:
    return np.asarray(a).tolist()


def subframe_to_dict(sub) -> Dict[str, Any]:
    if isinstance(sub, Constant):
        return {
            "type": "Constant",
            "block_size": sub.block_size,
            "dc_offset": sub.dc_offset,
            "bits_per_sample": sub.bits_per_sample,
        }
    if isinstance(sub, Verbatim):
        return {
            "type": "Verbatim",
            "samples": _arr(sub.samples),
            "bits_per_sample": sub.bits_per_sample,
        }
    if isinstance(sub, FixedLpc):
        return {
            "type": "FixedLpc",
            "warm_up": _arr(sub.warm_up),
            "residual": residual_to_dict(sub.residual),
            "bits_per_sample": sub.bits_per_sample,
        }
    if isinstance(sub, Lpc):
        p = sub.parameters
        return {
            "type": "Lpc",
            "warm_up": _arr(sub.warm_up),
            "parameters": {
                "coefs": _arr(p.coefs),
                "order": p.order,
                "shift": p.shift,
                "precision": p.precision,
            },
            "residual": residual_to_dict(sub.residual),
            "bits_per_sample": sub.bits_per_sample,
        }
    raise TypeError(type(sub))


def residual_to_dict(res: Residual) -> Dict[str, Any]:
    return {
        "partition_order": res.partition_order,
        "block_size": res.block_size,
        "warmup_length": res.warmup_length,
        "rice_params": _arr(res.rice_params),
        "quotients": _arr(res.quotients),
        "remainders": _arr(res.remainders),
    }


def residual_from_dict(d: Dict[str, Any]) -> Residual:
    return Residual(
        d["partition_order"],
        d["block_size"],
        d["warmup_length"],
        np.asarray(d["rice_params"], np.uint8),
        np.asarray(d["quotients"], np.uint32),
        np.asarray(d["remainders"], np.uint32),
    )


def subframe_from_dict(d: Dict[str, Any]):
    t = d["type"]
    if t == "Constant":
        return Constant(d["block_size"], d["dc_offset"], d["bits_per_sample"])
    if t == "Verbatim":
        return Verbatim(np.asarray(d["samples"], np.int32), d["bits_per_sample"])
    if t == "FixedLpc":
        return FixedLpc(
            np.asarray(d["warm_up"], np.int32),
            residual_from_dict(d["residual"]),
            d["bits_per_sample"],
        )
    if t == "Lpc":
        p = d["parameters"]
        return Lpc(
            np.asarray(d["warm_up"], np.int32),
            QuantizedParameters(
                np.asarray(p["coefs"], np.int16), p["order"], p["shift"], p["precision"]
            ),
            residual_from_dict(d["residual"]),
            d["bits_per_sample"],
        )
    raise ValueError(f"unknown subframe type {t}")


def header_to_dict(h: FrameHeader) -> Dict[str, Any]:
    return {
        "variable_block_size": h.variable_block_size,
        "block_size": h.block_size(),
        "channel_assignment": {
            "kind": h.channel_assignment.kind,
            "channels": h.channel_assignment.channels,
        },
        "sample_size_tag": h.sample_size_spec.tag,
        "sample_rate": h.sample_rate_spec.freq,
        "frame_number": h.frame_number,
        "start_sample_number": h.start_sample_number,
    }


def header_from_dict(d: Dict[str, Any]) -> FrameHeader:
    ca = ChannelAssignment(d["channel_assignment"]["kind"], d["channel_assignment"]["channels"])
    rate = d["sample_rate"]
    h = FrameHeader(
        BlockSizeSpec.from_size(d["block_size"]),
        ca,
        SampleSizeSpec(d["sample_size_tag"]),
        SampleRateSpec.from_freq(rate) if rate else SampleRateSpec.UNSPECIFIED,
    )
    if d["variable_block_size"]:
        h.set_start_sample_number(d["start_sample_number"])
    else:
        h.set_frame_number(d["frame_number"])
    return h


def frame_to_dict(f: Frame, include_bitstream_cache: bool = False) -> Dict[str, Any]:
    d = {
        "header": header_to_dict(f.header()),
        "subframes": [subframe_to_dict(s) for s in f.subframes()],
    }
    if include_bitstream_cache and f.precomputed_bitstream is not None:
        d["precomputed_bitstream"] = base64.b64encode(f.precomputed_bitstream).decode()
    return d


def frame_from_dict(d: Dict[str, Any]) -> Frame:
    f = Frame(
        header_from_dict(d["header"]),
        [subframe_from_dict(s) for s in d["subframes"]],
    )
    if "precomputed_bitstream" in d:
        f.precomputed_bitstream = base64.b64decode(d["precomputed_bitstream"])
    return f


def stream_info_to_dict(info: StreamInfo) -> Dict[str, Any]:
    return {
        "min_block_size": info.min_block_size,
        "max_block_size": info.max_block_size,
        "min_frame_size": info.min_frame_size,
        "max_frame_size": info.max_frame_size,
        "sample_rate": info.sample_rate,
        "channels": info.channels,
        "bits_per_sample": info.bits_per_sample,
        "total_samples": info.total_samples,
        "md5": info.md5.hex(),
    }


def stream_to_dict(s: Stream, include_bitstream_cache: bool = False) -> Dict[str, Any]:
    return {
        "stream_info": stream_info_to_dict(s.stream_info()),
        "metadata": [
            {"is_last": m.is_last, "typetag": m.typetag,
             "data": base64.b64encode(bytes(m.data)).decode()}
            for m in s.metadata()
            if not isinstance(m.data, StreamInfo)
        ],
        "frames": [frame_to_dict(f, include_bitstream_cache) for f in s.frames()],
    }


def stream_from_dict(d: Dict[str, Any]) -> Stream:
    info = d["stream_info"]
    s = Stream(info["sample_rate"], info["channels"], info["bits_per_sample"])
    si = s.stream_info_mut()
    si.min_block_size = info["min_block_size"]
    si.max_block_size = info["max_block_size"]
    si.min_frame_size = info["min_frame_size"]
    si.max_frame_size = info["max_frame_size"]
    si.total_samples = info["total_samples"]
    si.md5 = bytes.fromhex(info["md5"])
    for m in d["metadata"]:
        s.metadata_.append(
            MetadataBlock(m["is_last"], m["typetag"], base64.b64decode(m["data"]))
        )
    for fd in d["frames"]:
        s.frames_.append(frame_from_dict(fd))
    return s


def dump_stream(s: Stream, path: str, **kw) -> None:
    with open(path, "w") as f:
        json.dump(stream_to_dict(s, **kw), f)


def load_stream(path: str) -> Stream:
    with open(path) as f:
        return stream_from_dict(json.load(f))
