"""Encoder configuration tree with TOML round-trip.

Field names, defaults, and validation mirror the reference's
``flacenc-rs/src/config.rs`` so existing flacenc TOML configs load
unchanged. ``multithread``/``workers`` control the host-side C++ frame
PACKER thread pool (`parallel.determine_worker_count`, the par.rs:328-339
precedence: config -> env FLACENC_WORKERS -> auto); device parallelism is
the batch axis and is governed by `batch_size`/`mesh`, while the
host<->device pipelining depth is FLACENC_PIPELINE_DEPTH.
"""

from __future__ import annotations

import dataclasses
import io
import tomllib
from typing import Optional

from . import constants
from .errors import Verified, VerifyError, into_verified, verify_range, verify_true


@dataclasses.dataclass
class Window:
    """Analysis window descriptor (config.rs:344-387).

    ``type`` is "Rectangle" or "Tukey"; Tukey carries ``alpha``.
    """

    type: str = "Tukey"
    alpha: float = constants.qlpc.DEFAULT_TUKEY_ALPHA

    @staticmethod
    def rectangle() -> "Window":
        return Window(type="Rectangle", alpha=0.0)

    @staticmethod
    def tukey(alpha: float) -> "Window":
        return Window(type="Tukey", alpha=alpha)

    def verify(self) -> None:
        if self.type not in ("Rectangle", "Tukey"):
            raise VerifyError("window.type", f"unknown window type {self.type!r}")
        if self.type == "Tukey" and not (0.0 <= self.alpha <= 1.0):
            raise VerifyError(
                "tukey.alpha", "alpha must be in range between 0 and 1"
            )

    def to_dict(self) -> dict:
        d = {"type": self.type}
        if self.type == "Tukey":
            d["alpha"] = self.alpha
        return d

    @staticmethod
    def from_dict(d: dict) -> "Window":
        w = Window(type=d.get("type", "Tukey"))
        if w.type == "Tukey":
            w.alpha = float(d.get("alpha", constants.qlpc.DEFAULT_TUKEY_ALPHA))
        else:
            w.alpha = 0.0
        return w


@dataclasses.dataclass
class OrderSel:
    """Fixed-LPC order-selection algorithm (config.rs:400-432).

    ``type`` is "BitCount" (exact Rice search per order) or "ApproxEnt"
    (partitioned entropy estimate, the default).
    """

    type: str = "ApproxEnt"
    partitions: int = constants.DEFAULT_ENTROPY_ESTIMATOR_PARTITIONS

    @staticmethod
    def bit_count() -> "OrderSel":
        return OrderSel(type="BitCount")

    @staticmethod
    def approx_ent(partitions: int = constants.DEFAULT_ENTROPY_ESTIMATOR_PARTITIONS) -> "OrderSel":
        return OrderSel(type="ApproxEnt", partitions=partitions)

    def verify(self) -> None:
        if self.type not in ("BitCount", "ApproxEnt"):
            raise VerifyError("order_sel.type", f"unknown selector {self.type!r}")
        if self.type == "ApproxEnt":
            verify_range(
                "ApproxEnt.partitions",
                self.partitions,
                1,
                constants.MAX_ENTROPY_ESTIMATOR_PARTITIONS,
            )

    def to_dict(self) -> dict:
        d = {"type": self.type}
        if self.type == "ApproxEnt":
            d["partitions"] = self.partitions
        return d

    @staticmethod
    def from_dict(d: dict) -> "OrderSel":
        o = OrderSel(type=d.get("type", "ApproxEnt"))
        if o.type == "ApproxEnt":
            o.partitions = int(
                d.get("partitions", constants.DEFAULT_ENTROPY_ESTIMATOR_PARTITIONS)
            )
        return o


@dataclasses.dataclass
class Prc:
    """Partitioned-Rice-coding config (config.rs:211-229)."""

    max_parameter: int = constants.rice.MAX_RICE_PARAMETER

    def verify(self) -> None:
        # lower bound 0: the reference's usize type rejects negatives at
        # deserialization (config.rs:211-229)
        verify_range(
            "max_parameter", self.max_parameter, 0, constants.rice.MAX_RICE_PARAMETER
        )

    def to_dict(self) -> dict:
        return {"max_parameter": self.max_parameter}

    @staticmethod
    def from_dict(d: dict) -> "Prc":
        return Prc(max_parameter=int(d.get("max_parameter", constants.rice.MAX_RICE_PARAMETER)))


@dataclasses.dataclass
class Fixed:
    """Fixed-LPC config (config.rs:236-264)."""

    max_order: int = constants.fixed.MAX_LPC_ORDER
    order_sel: OrderSel = dataclasses.field(default_factory=OrderSel)

    def verify(self) -> None:
        verify_range("max_order", self.max_order, 0, constants.fixed.MAX_LPC_ORDER)
        self.order_sel.verify()

    def to_dict(self) -> dict:
        return {"max_order": self.max_order, "order_sel": self.order_sel.to_dict()}

    @staticmethod
    def from_dict(d: dict) -> "Fixed":
        return Fixed(
            max_order=int(d.get("max_order", constants.fixed.MAX_LPC_ORDER)),
            order_sel=OrderSel.from_dict(d.get("order_sel", {})),
        )


@dataclasses.dataclass
class Qlpc:
    """Quantized-LPC config (config.rs:271-326)."""

    lpc_order: int = constants.qlpc.DEFAULT_ORDER
    quant_precision: int = constants.qlpc.DEFAULT_PRECISION
    use_direct_mse: bool = False
    mae_optimization_steps: int = 0
    window: Window = dataclasses.field(default_factory=Window)

    def verify(self) -> None:
        verify_range("lpc_order", self.lpc_order, 1, constants.qlpc.MAX_ORDER)
        verify_range(
            "quant_precision", self.quant_precision, 1, constants.qlpc.MAX_PRECISION
        )
        try:
            self.window.verify()
        except VerifyError as e:
            raise e.within("window")

    def to_dict(self) -> dict:
        return {
            "lpc_order": self.lpc_order,
            "quant_precision": self.quant_precision,
            "use_direct_mse": self.use_direct_mse,
            "mae_optimization_steps": self.mae_optimization_steps,
            "window": self.window.to_dict(),
        }

    @staticmethod
    def from_dict(d: dict) -> "Qlpc":
        q = Qlpc()
        q.lpc_order = int(d.get("lpc_order", q.lpc_order))
        q.quant_precision = int(d.get("quant_precision", q.quant_precision))
        q.use_direct_mse = bool(d.get("use_direct_mse", False))
        q.mae_optimization_steps = int(d.get("mae_optimization_steps", 0))
        q.window = Window.from_dict(d.get("window", {}))
        return q


@dataclasses.dataclass
class StereoCoding:
    """Stereo-mode search toggles (config.rs:137-160)."""

    use_leftside: bool = True
    use_rightside: bool = True
    use_midside: bool = True

    def verify(self) -> None:
        pass

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "StereoCoding":
        s = StereoCoding()
        s.use_leftside = bool(d.get("use_leftside", True))
        s.use_rightside = bool(d.get("use_rightside", True))
        s.use_midside = bool(d.get("use_midside", True))
        return s


@dataclasses.dataclass
class SubFrameCoding:
    """Per-channel coding config (config.rs:167-204).

    Verbatim cannot be disabled (every signal must stay encodable).
    """

    use_constant: bool = True
    use_fixed: bool = True
    use_lpc: bool = True
    fixed: Fixed = dataclasses.field(default_factory=Fixed)
    qlpc: Qlpc = dataclasses.field(default_factory=Qlpc)
    prc: Prc = dataclasses.field(default_factory=Prc)

    def verify(self) -> None:
        try:
            self.qlpc.verify()
        except VerifyError as e:
            raise e.within("qlpc")
        try:
            self.prc.verify()
        except VerifyError as e:
            raise e.within("prc")
        self.fixed.verify()

    def to_dict(self) -> dict:
        return {
            "use_constant": self.use_constant,
            "use_fixed": self.use_fixed,
            "use_lpc": self.use_lpc,
            "fixed": self.fixed.to_dict(),
            "qlpc": self.qlpc.to_dict(),
            "prc": self.prc.to_dict(),
        }

    @staticmethod
    def from_dict(d: dict) -> "SubFrameCoding":
        s = SubFrameCoding()
        s.use_constant = bool(d.get("use_constant", True))
        s.use_fixed = bool(d.get("use_fixed", True))
        s.use_lpc = bool(d.get("use_lpc", True))
        s.fixed = Fixed.from_dict(d.get("fixed", {}))
        s.qlpc = Qlpc.from_dict(d.get("qlpc", {}))
        s.prc = Prc.from_dict(d.get("prc", {}))
        return s


@dataclasses.dataclass
class Encoder:
    """Top-level encoder config (config.rs:85-130)."""

    block_size: int = constants.DEFAULT_BLOCK_SIZE
    multithread: bool = True
    workers: Optional[int] = None
    stereo_coding: StereoCoding = dataclasses.field(default_factory=StereoCoding)
    subframe_coding: SubFrameCoding = dataclasses.field(default_factory=SubFrameCoding)

    def verify(self) -> None:
        verify_range(
            "block_size", self.block_size, constants.MIN_BLOCK_SIZE, constants.MAX_BLOCK_SIZE
        )
        if self.workers is not None:
            verify_true("workers", self.workers >= 1, "must be >= 1")
        try:
            self.stereo_coding.verify()
        except VerifyError as e:
            raise e.within("stereo_coding")
        try:
            self.subframe_coding.verify()
        except VerifyError as e:
            raise e.within("subframe_coding")

    def into_verified(self) -> Verified["Encoder"]:
        return into_verified(self)

    def to_dict(self) -> dict:
        d = {
            "block_size": self.block_size,
            "multithread": self.multithread,
            "stereo_coding": self.stereo_coding.to_dict(),
            "subframe_coding": self.subframe_coding.to_dict(),
        }
        if self.workers is not None:
            d["workers"] = self.workers
        return d

    def to_toml(self) -> str:
        return _emit_toml(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "Encoder":
        e = Encoder()
        e.block_size = int(d.get("block_size", constants.DEFAULT_BLOCK_SIZE))
        e.multithread = bool(d.get("multithread", True))
        w = d.get("workers")
        e.workers = int(w) if w is not None else None
        e.stereo_coding = StereoCoding.from_dict(d.get("stereo_coding", {}))
        e.subframe_coding = SubFrameCoding.from_dict(d.get("subframe_coding", {}))
        return e

    @staticmethod
    def from_toml(text: str) -> "Encoder":
        return Encoder.from_dict(tomllib.loads(text))


def _toml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    return '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'


def _emit_toml(d: dict, prefix: str = "", out: io.StringIO | None = None) -> str:
    """Minimal TOML emitter for the (nested-dict, scalar-leaf) config schema."""
    top = out is None
    if out is None:
        out = io.StringIO()
    tables = []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append((k, v))
        else:
            out.write(f"{k} = {_toml_scalar(v)}\n")
    for k, v in tables:
        path = f"{prefix}{k}"
        out.write(f"\n[{path}]\n")
        _emit_toml(v, prefix=path + ".", out=out)
    return out.getvalue() if top else ""
