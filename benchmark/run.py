"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration (``benchmark/configs/<config>.json``), its
traffic mix (``benchmark/traffic/<mix>.json``, read by
``benchmark.traffic``) and its metrics (``benchmark/metrics/<name>.py``)
are found by name from ``BENCHMARK.json``. Set-up builds the inputs from
the seed and warms the program as the mix says; then the mix's callers
send its sources to the entry it names (``encode_with_fixed_block_size``
or ``encode_corpus`` of ``flacenc_tpu_torch``, with the configuration's
entry arguments), in a closed or an open loop, until `--seconds` have
passed, and every call started inside the window is waited for. With ``--trace 1`` the calls run
with ``FLACENC_TIMELINE=1`` and ``torch.profiler`` records a few seconds
of the window's middle; the line then carries the per-layer metrics.
After the window ``benchmark.check`` holds what the calls produced to the
plain reference. Exits 3, printing no result, without the cards the cell
asks for, and 4 if JAX or the JAX package was loaded.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "flacenc_tpu")


class Run:
    """What a finished run hands the metric readers."""

    def __init__(self, config: dict, chips: int):
        self.config = config
        self.per_card_batch = config["entry"]["batch_size"] // chips
        # one dict a call: items (source indices), arrival, t0, t1, audio_s,
        # samples, nbytes, stats (the encoder's counters), error
        self.calls = []
        self.window_start = None
        self.setup_s = None
        self.captures = None   # CAPTURE_COUNTS (before, after) the window
        self.profile = None    # benchmark.trace.summarize of the traced span
        self.host = None       # _host_clocks() at the window's start and once it closed


def load_manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_and_config(manifest: dict, workload: str) -> tuple:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        return cell, json.load(f)


def metrics_of(manifest: dict, kind: str, workload: str) -> list:
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def read_metric(name: str, run: Run):
    return importlib.import_module(f"benchmark.metrics.{name.split('.')[0]}").read(run)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _clean_env(trace: bool) -> None:
    """The library's defaults: no FLACENC_* setting but the timeline, which
    the traced run turns on; transformers-style JAX back ends off."""
    for k in [k for k in os.environ if k.startswith("FLACENC_")]:
        del os.environ[k]
    if trace:
        os.environ["FLACENC_TIMELINE"] = "1"
    os.environ["USE_FLAX"] = "0"


def _cards(torch, n: int) -> list:
    from . import smi

    lines = smi.lines()
    return [{"device": f"cuda:{i}", "name": torch.cuda.get_device_name(i),
             "smi": lines[i] if i < len(lines) else None} for i in range(n)]


def _host_clocks() -> dict:
    """This process's CPU seconds and context switches, and the machine's
    CPU ticks by kind from /proc/stat (absent where it is not readable)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"user_s": ru.ru_utime, "sys_s": ru.ru_stime, "vcsw": ru.ru_nvcsw,
           "ivcsw": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            ticks = [int(v) for v in f.readline().split()[1:]]
        out["ticks"] = ticks
    except (OSError, ValueError):
        pass
    return out


def _host_note(a: dict, b: dict, wall: float, audio_s: float) -> str:
    cpu = (b["user_s"] - a["user_s"]) + (b["sys_s"] - a["sys_s"])
    note = (f"process cpu {cpu:.3f} s (user {b['user_s'] - a['user_s']:.3f}, sys "
            f"{b['sys_s'] - a['sys_s']:.3f}) over {wall:.3f} s of wall, "
            f"{1000 * cpu / max(audio_s, 1e-9):.4f} cpu_ms/audio_s; context switches "
            f"{b['vcsw'] - a['vcsw']} voluntary, {b['ivcsw'] - a['ivcsw']} involuntary")
    if "ticks" in a and "ticks" in b:
        d = [y - x for x, y in zip(a["ticks"], b["ticks"])]
        total = max(1, sum(d))
        idle = d[3] + (d[4] if len(d) > 4 else 0)
        steal = d[7] if len(d) > 7 else 0
        note += (f"; machine busy {100 * (total - idle) / total:.2f} %, steal "
                 f"{100 * steal / total:.2f} %, load {os.getloadavg()}")
    return note


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _caller(mix: dict, enc_cfg, fmt: dict, block: int, entry: dict):
    """call(sources, items, stats) -> [(source index, stream bytes)]: one
    call of the mix's entry on those sources, with the configuration's
    entry arguments; the encoder's counters land in `stats`."""
    import dataclasses

    from flacenc_tpu_torch import encode_corpus
    from flacenc_tpu_torch.models import batch_encoder as be
    from flacenc_tpu_torch.source import MemSource

    def mem(src):
        return MemSource(src.pcm.reshape(-1), fmt["channels"], fmt["bits_per_sample"], src.rate)

    def stream(sources, items, stats):
        (k,) = items
        out = be.encode_with_fixed_block_size(enc_cfg, mem(sources[k]), block, stats=stats,
                                              **entry)
        return [(k, out.to_bytes())]

    def corpus(sources, items, stats):
        streams, counters = encode_corpus([(sources[k].name, mem(sources[k])) for k in items],
                                          enc_cfg, block, **entry)
        stats.update(dataclasses.asdict(counters))
        return [(k, streams[sources[k].name].to_bytes()) for k in items]

    return stream if mix["call"] == "encode_with_fixed_block_size" else corpus


def _jobs(mix: dict, n: int) -> list:
    """One pass of the mix as calls: the source indices of each."""
    per = mix.get("corpus_items", 1) if mix["call"] == "encode_corpus" else 1
    return [list(range(i, min(n, i + per))) for i in range(0, n, per)]


def _drive(mix: dict, run: Run, sources: list, jobs: list, call, seconds: float, seed: int,
           profiler) -> list:
    """Sends the mix's calls for `seconds` from `run.window_start`, as the
    mix says, and waits for every call started in the window; each call's
    record goes to `run.calls`, its output to the list returned beside it.
    One closed-loop caller runs on this thread, and the profiler starts and
    stops between its calls; more callers, or an open loop, run on threads
    of their own while this one ticks the profiler."""
    from . import traffic

    end = run.window_start + seconds
    lock = threading.Lock()
    outputs = []
    due = None
    if mix["loop"] == "open":
        due = [run.window_start + t for t in traffic.arrivals(mix, seconds, seed)]
    state = {"next": 0}

    def one(i: int, arrival: float) -> None:
        items = jobs[i % len(jobs)]
        stats, out, error = {}, None, None
        t0 = time.perf_counter()
        try:
            out = call(sources, items, stats)
        except Exception as e:  # a failed call counts against `correct`
            error = f"{type(e).__name__}: {e}"
        t1 = time.perf_counter()
        record = {"items": items, "arrival": arrival, "t0": t0, "t1": t1,
                  "audio_s": sum(sources[k].audio_s for k in items),
                  "samples": sum(sources[k].pcm.size for k in items), "stats": stats,
                  "nbytes": sum(len(d) for _, d in out) if out else 0, "error": error}
        with lock:
            run.calls.append(record)
            outputs.append(out)

    def take():
        """The next call's index and arrival, or None once the window is
        over."""
        with lock:
            i = state["next"]
            if due is not None:
                if i >= len(due):
                    return None
                state["next"] = i + 1
                return i, due[i]
            now = time.perf_counter()
            if now >= end:
                return None
            state["next"] = i + 1
            return i, now

    def caller() -> None:
        while True:
            got = take()
            if got is None:
                return
            i, arrival = got
            wait = arrival - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            one(i, arrival)

    if mix["loop"] == "closed" and mix["callers"] == 1:
        while True:
            if profiler:
                profiler.tick(time.perf_counter() - run.window_start, seconds)
            got = take()
            if got is None:
                break
            one(*got)
    else:
        threads = [threading.Thread(target=caller, name=f"caller{j}", daemon=True)
                   for j in range(mix["callers"])]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            if profiler:
                profiler.tick(time.perf_counter() - run.window_start, seconds)
            time.sleep(0.02)
        for t in threads:
            t.join()
    order = sorted(range(len(run.calls)), key=lambda j: run.calls[j]["t0"])
    run.calls = [run.calls[j] for j in order]
    return [outputs[j] for j in order]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # rehearsal on the CPU at a reduced scale (the benchmark's own tests)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--scale", type=float, default=1.0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    trace = bool(args.trace)
    seed = args.seed % (1 << 63)

    manifest = load_manifest()
    cell, cfg = cell_and_config(manifest, args.workload)
    chips = cell["chips"]
    on_card = args.device == "cuda"
    _clean_env(trace)
    if on_card:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", ",".join(str(i) for i in range(chips)))

    import torch

    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"benchmark.run: the cell asks for {chips} card(s), {n} visible")
        return 3

    from flacenc_tpu_torch import config as pconfig
    from flacenc_tpu_torch.models import batch_encoder as be
    from flacenc_tpu_torch.parallel import mesh as pmesh

    from . import check, trace as tr, traffic

    fmt, entry, block = cfg["format"], dict(cfg["entry"]), cfg["block_size"]
    enc_cfg = pconfig.Encoder.from_dict(cfg["encoder"]).into_verified()
    if on_card:
        entry["device"] = "cuda"
    else:
        entry["device"] = "cpu"
        entry["mesh"] = pmesh.block_mesh(["cpu"] * chips) if chips > 1 else None
    mix = traffic.load_mix(cell["traffic"])
    t_imports = time.perf_counter()
    sources = traffic.generate(mix, fmt, seed, args.scale)
    run = Run(cfg, chips)
    log(f"set-up: start to imports {t_imports - _T_START:.3f} s, synthesis "
        f"{time.perf_counter() - t_imports:.3f} s")
    call = _caller(mix, enc_cfg, fmt, block, entry)
    jobs = _jobs(mix, len(sources))

    # warm the programs the traffic meets: the mix's sources, at a fraction
    # of their lengths, once a pass. The upload-wire racer picks a wire, and
    # so a program, per batch from the content and from its own timings; a
    # "packed" pass sends every batch on a packed wire
    # (FLACENC_PACKED_UPLOAD=1), which meets the packed wires' programs
    for n, warm in enumerate(mix["warm"]):
        t_pass = time.perf_counter()
        warm_sources = sources if warm["scale"] == 1 else traffic.generate(
            mix, fmt, seed, args.scale * warm["scale"])
        if warm["upload"] == "packed":
            os.environ["FLACENC_PACKED_UPLOAD"] = "1"
        try:
            for job in _jobs(mix, len(warm_sources)):
                call(warm_sources, job, {})
        finally:
            os.environ.pop("FLACENC_PACKED_UPLOAD", None)
        failed = be.wait_all_warms(timeout=600)
        if failed:
            raise RuntimeError(f"warm-ups failed: {failed}")
        log(f"set-up: warm pass {n} ({warm['upload']}, scale {warm['scale']}) "
            f"{time.perf_counter() - t_pass:.3f} s, captures {be.CAPTURE_COUNTS}")
    profiler = tr.Window(on_card, cfg["trace"]) if trace else None
    if profiler:
        profiler.prime()
    if on_card:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    run.captures = (dict(be.CAPTURE_COUNTS), None)
    clocks = _host_clocks()
    run.window_start = time.perf_counter()
    run.setup_s = run.window_start - _T_START
    outputs = _drive(mix, run, sources, jobs, call, args.seconds, seed, profiler)
    t_end = time.perf_counter()
    run.host = (clocks, _host_clocks())
    log("window: host: " + _host_note(*run.host, t_end - run.window_start,
                                      sum(c["audio_s"] for c in run.calls)))
    if profiler:
        profiler.stop()
    run.captures = (run.captures[0], dict(be.CAPTURE_COUNTS))
    wires = {}
    for c in run.calls:
        for w, n in (c["stats"].get("wire_batches") or {}).items():
            wires[w] = wires.get(w, 0) + n
    log(f"window: {len(run.calls)} calls, walls " + " ".join(
        f"{c['t1'] - c['t0']:.3f}" for c in run.calls) + f"; captures {run.captures[1]}; "
        f"batches by upload wire {wires}; grouped batches "
        f"{sum(c['stats'].get('grouped_batches') or 0 for c in run.calls)}")
    from .metrics import _stats

    log("window: per batch, ms: " + ", ".join(
        f"{k} {_stats.per_batch_ms(run, k)}" for k in ("read_s", "submit_s", "device_wait_s",
                                                         "pack_s")))
    if on_card:
        peak = max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count()))
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
               "memory_peak_bytes": peak, "cards": _cards(torch, chips)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

    bad = forbidden_loaded()
    if bad:
        log(f"benchmark.run: modules loaded that must not be: {bad}")
        return 4

    line = {"correct": False, "attempted": len(run.calls),
            "failed": sum(1 for c in run.calls if c["error"]), "metrics": {}, "device": dev}
    kind = "per_layer" if trace else "end_to_end"
    if trace:
        run.profile = profiler.summarize(run.calls)
        dev["busy_s"] = sum(c["busy_s"] for c in run.profile["cards"]) / max(1, len(run.profile["cards"]))
        dev["window_s"] = run.profile["window_s"]
        line["breakdown"] = run.profile["breakdown"]
    for m in metrics_of(manifest, kind, args.workload):
        v = read_metric(m["name"], run)
        if v is not None:
            line["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
    if on_card:
        dev["forward_bound"] = tr.bound_note(cfg, run.per_card_batch)

    # the program's state goes before the reference runs
    be.close_capture_threads()
    if on_card:
        torch.cuda.empty_cache()
    calls = []
    for c, out in zip(run.calls, outputs):
        if c["error"]:
            calls += [{"source": k, "data": None, "error": c["error"]} for k in c["items"]]
        else:
            calls += [{"source": k, "data": d, "error": None} for k, d in out]
    numbers = check.check(sources, calls, fmt, cfg["encoder"], block, seed,
                          cfg["check"]["frames"])
    correct, rows = check.verdict(numbers, cfg["check"]["limits"])
    line["correct"] = correct
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for note in numbers["notes"][:20]:
        log(f"check: {note}")
    log(f"check: {numbers['frames_checked']} frames compared with the reference")
    for k, v, lim in rows:
        log(f"check {k} = {v} (limit {lim})")
    log(f"correct = {correct}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
