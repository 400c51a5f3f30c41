"""The one traffic generator: it reads a mix's parameters from
``benchmark/traffic/<mix>.json`` and the audio format from the
configuration, and makes the calls' PCM from the seed. A new mix is a new
data file; `benchmark.run` drives it as the file says.

A mix file holds what the sources are:

- ``items``: how many sources one pass of the mix hands the encoder;
- ``length_s``: their lengths, ``{"kind", "lo", "hi"}``: the quantiles of
  a distribution between ``lo`` and ``hi``, ``"even"`` (uniform) or
  ``"log_uniform"``. Every seed gets the same set of lengths; the seed sets
  only their order;
- ``sections``: the share of each program type (``programs.PROGRAMS``) in
  every source, in a seeded order, so that every source makes the same kind
  of work whatever its length;
- ``segment_s``: [lo, hi] seconds of the seeded segment of each program
  that the sections tile, each from a seeded offset;
- ``gain``: ``{"depth", "period_s": [lo, hi]}``, a slow seeded swell over
  each source (1 - depth to 1), so that no two tiled blocks are equal;
- ``sample_rates`` (optional): ``{"<rate>": share}``, the share of the
  sources at each rate, in a seeded order; without it every source has the
  configuration's rate;
- ``material_seed`` (optional): where it is given, the programs, the
  sections, the swell and the rates of the source of each length come from
  it and not from the run's seed, so that every seed encodes the same
  work; the run's seed then sets the sources' order and, for each source,
  a rotation by up to a block of samples, whether its channels run in
  reverse order and whether its polarity is inverted (clipped to the
  depth's range), which change every sample and not the work;

how they are sent (`benchmark.run`):

- ``call``: ``"encode_with_fixed_block_size"``, one call a source, or
  ``"encode_corpus"``, one call for every ``corpus_items`` sources;
- ``loop``: ``"closed"`` (each of ``callers`` threads sends the next call
  when its last one is done, cycling through the pass until the window
  ends) or ``"open"`` (calls arrive at ``rate_per_s``, the gaps the
  quantiles of an exponential distribution in a seeded order, and wait for
  one of ``callers`` threads);

and how set-up warms the program: ``warm``, a list of passes
``{"upload", "scale"}``, each sending the mix's sources for the same seed
once, every length times ``scale``, one call after the other, with
``"upload": "packed"`` every batch on a packed upload wire, with
``"default"`` on the library's own choice.

The channels and the sample depth come from the configuration: channel c
takes the program's channel c % 2, delayed by c // 2 * 7 samples.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from . import programs

HERE = os.path.dirname(os.path.abspath(__file__))
CALLS = ("encode_with_fixed_block_size", "encode_corpus")
LOOPS = ("closed", "open")
WARM_UPLOADS = ("packed", "default")


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    check_mix(mix)
    return mix


def check_mix(mix: dict) -> None:
    """Raises ValueError where a mix asks for what this generator or
    `benchmark.run` does not do."""
    if mix["length_s"]["kind"] not in LENGTH_KINDS:
        raise ValueError(f"length_s.kind: one of {sorted(LENGTH_KINDS)}")
    unknown = set(mix["sections"]) - set(programs.PROGRAMS)
    if unknown:
        raise ValueError(f"unknown program types {sorted(unknown)}")
    if mix["call"] not in CALLS or mix["loop"] not in LOOPS or mix["callers"] < 1:
        raise ValueError(f"call: one of {CALLS}; loop: one of {LOOPS}; callers >= 1")
    if mix["loop"] == "open" and not mix.get("rate_per_s", 0) > 0:
        raise ValueError("an open loop needs rate_per_s > 0")
    if mix["call"] == "encode_corpus" and not mix.get("corpus_items", 0) >= 1:
        raise ValueError("encode_corpus needs corpus_items >= 1")
    if any(p["upload"] not in WARM_UPLOADS or not p["scale"] > 0 for p in mix["warm"]):
        raise ValueError(f"warm: passes of upload one of {WARM_UPLOADS} and scale > 0")


@dataclasses.dataclass
class Source:
    """One source's input: (frames, channels) int32 PCM at `rate`."""

    name: str
    pcm: np.ndarray
    rate: int

    @property
    def frames(self) -> int:
        return self.pcm.shape[0]

    @property
    def audio_s(self) -> float:
        return self.frames / self.rate


LENGTH_KINDS = {
    "even": lambda q, lo, hi: lo + q * (hi - lo),
    "log_uniform": lambda q, lo, hi: np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo))),
}


def lengths(spec: dict, n: int) -> List[float]:
    """The n quantiles of the length distribution, shortest first."""
    q = (np.arange(n) + 0.5) / n
    return [float(x) for x in LENGTH_KINDS[spec["kind"]](q, float(spec["lo"]), float(spec["hi"]))]


def shares(spec: Dict[str, float], n: int) -> List[str]:
    """n labels, each key of `spec` about its share of them (largest
    remainders), in the keys' order."""
    keys = list(spec)
    w = np.array([spec[k] for k in keys], np.float64)
    want = w / w.sum() * n
    count = np.floor(want).astype(int)
    for i in np.argsort(-(want - count), kind="stable")[:n - count.sum()]:
        count[i] += 1
    return [k for k, c in zip(keys, count) for _ in range(c)]


def _bank(mix: dict, rng: np.random.Generator, rate: int) -> Dict[str, np.ndarray]:
    lo, hi = mix["segment_s"]
    return {name: programs.PROGRAMS[name](rng, int(rng.uniform(lo, hi) * rate), rate)
            .astype(np.float32) for name in mix["sections"]}


def _plan(mix: dict, bank: dict, rng: np.random.Generator, seconds: float, rate: int) -> dict:
    """Every random draw of one source: its sections (program, length,
    where in the program's segment it starts) and its swell."""
    n = int(round(seconds * rate))
    names = list(mix["sections"])
    cuts = np.cumsum([0.0] + [mix["sections"][k] for k in names]) / sum(mix["sections"].values())
    sections = []
    for i in rng.permutation(len(names)):
        part = int(round(cuts[i + 1] * n)) - int(round(cuts[i] * n))
        sections.append((names[i], part, int(rng.integers(0, len(bank[names[i]])))))
    return {"n": n, "rate": rate, "sections": sections,
            "period": rng.uniform(*mix["gain"]["period_s"]), "phase": rng.uniform(0, 6.28)}


def _render(plan: dict, bank: dict, depth: float, channels: int, bps: int) -> np.ndarray:
    """The source's PCM: each section tiles its program's segment from its
    start, under the swell 1 - depth * (1 + sin) / 2."""
    n, rate = plan["n"], plan["rate"]
    out = np.empty((n, 2), np.float32)
    pos = 0
    for name, part, start in plan["sections"]:
        seg = bank[name]
        k = 0
        while k < part:
            take = min(part - k, len(seg) - start)
            out[pos + k:pos + k + take] = seg[start:start + take]
            k, start = k + take, 0
        pos += part
    t = np.arange(n, dtype=np.float32) * np.float32(2 * np.pi / (plan["period"] * rate))
    gain = np.sin(t + np.float32(plan["phase"]), out=t)
    gain *= np.float32(-0.5 * depth)
    gain += np.float32(1.0 - 0.5 * depth)
    out *= gain[:, None]
    if channels != 2:
        out = np.stack([np.roll(out[:, c % 2], c // 2 * 7) for c in range(channels)], axis=1)
    return programs.quantize(out, bps)


def _render_all(plans: list, banks: dict, mix: dict, channels: int, bps: int) -> list:
    workers = max(1, min(8, len(os.sched_getaffinity(0))))
    depth = mix["gain"]["depth"]
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda p: _render(p, banks[p["rate"]], depth, channels, bps), plans))


def generate(mix: dict, fmt: dict, seed: int, scale: float = 1.0) -> List[Source]:
    """One pass of the mix for `seed`, in call order. `scale` shortens every
    length (the warm-up's sources, and tests)."""
    rng = np.random.default_rng(seed)
    fixed = mix.get("material_seed") is not None
    material = np.random.default_rng(mix["material_seed"]) if fixed else rng
    bps, n = fmt["bits_per_sample"], mix["items"]
    rate_of: Optional[List[int]] = None
    if mix.get("sample_rates"):
        rate_of = [int(r) for r in shares(mix["sample_rates"], n)]
    rates = sorted(set(rate_of)) if rate_of else [fmt["sample_rate"]]
    banks = {r: _bank(mix, material, r) for r in rates}
    order = rng.permutation(n)
    if rate_of:
        rate_of = [rate_of[i] for i in material.permutation(n)]
    rate = (lambda i: rate_of[i]) if rate_of else (lambda i: rates[0])
    sizes = lengths(mix["length_s"], n)
    if fixed:  # the source of length k is the same for every seed
        by_length = [_plan(mix, banks[rate(k)], material, sizes[k] * scale, rate(k))
                     for k in range(n)]
        plans = [by_length[k] for k in order]
    else:
        plans = [_plan(mix, banks[rate(j)], rng, sizes[k] * scale, rate(j))
                 for j, k in enumerate(order)]
    pcms = _render_all(plans, banks, mix, fmt["channels"], bps)
    if fixed:
        pcms = [_vary(pcm, rng, bps) for pcm in pcms]
    return [Source(f"item{k:03d}", pcm, p["rate"]) for k, pcm, p in zip(order, pcms, plans)]


def _vary(pcm: np.ndarray, rng: np.random.Generator, bps: int) -> np.ndarray:
    """The source rotated by 1 to 4095 samples, its channels perhaps in
    reverse order and its polarity perhaps inverted, as `rng` draws."""
    shift, reverse, invert = int(rng.integers(1, 4096)), rng.integers(0, 2), rng.integers(0, 2)
    out = np.roll(pcm[:, ::-1] if reverse else pcm, shift, axis=0)
    if invert:
        np.negative(out, out=out)
        np.minimum(out, (1 << (bps - 1)) - 1, out=out)
    return out


def arrivals(mix: dict, seconds: float, seed: int) -> List[float]:
    """An open loop's arrival times in the window (seconds from its
    start): ceil(rate x seconds) gaps, the quantiles of an exponential
    distribution of mean 1 / rate, in a seeded order."""
    rate = float(mix["rate_per_s"])
    n = max(1, int(np.ceil(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = gaps[np.random.default_rng([seed, 3]).permutation(n)]
    t = np.cumsum(gaps) - gaps[0]
    return [float(x) for x in t if x < seconds]
