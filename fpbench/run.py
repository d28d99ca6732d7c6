"""The port's benchmark: one run of one cell.

    python3 -m fpbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  A cell is one
entry of its ``workloads``: a configuration (``fpbench/configs/``) under a
traffic mix (``fpbench/traffic/<traffic>.json``), with the limits of its
comparison in ``fpbench/workloads/<name>.json``.  Every metric is read by
``fpbench/metrics/<metric>.py``; nothing here names a cell, a traffic mix
or a metric.

A run makes its inputs from the seed on the card, writes the catalogue as
a DB directory under ``TMPDIR``, loads it with the program's own loaders,
warms up on the cell's shapes, then drives a closed loop for ``--seconds``:
one batch in flight, the next sent when the previous batch's top-1 answers
are on the host.  Audio queries go through ``Embedder.embed_songs`` and
``Database.query_top1_batch``, fingerprint queries through the latter
alone (the body of ``matcher --top1``'s flush).  Under ``--trace 1`` the
window runs under ``torch.profiler`` with the program's own spans
recording (``pfann_tpu_torch.utils.profiling``), and
``fpbench/program_trace.py`` puts the card's work and idle time down to
them; ``--trace 0`` records no span.  Once the window has
closed and the program's state is freed, ``fpbench/reference/`` works the
checked answers out again in float32; the last line of standard output is
the result, the last lines of standard error each number compared beside
its limit.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fpbench import generate, program_trace  # noqa: E402
from fpbench.check import compare  # noqa: E402
from fpbench.trace import WINDOW, Spans, read_trace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WARMUP_BATCHES = 3
# top-level modules that must not be loaded in a run: JAX and the JAX
# package (``pfann_tpu_torch`` is another name, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "pfann_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries of the metrics this cell reports
    per_layer: list


@dataclasses.dataclass
class Reading:
    """What a metric reader may read of one run."""

    cell: Cell
    engine: str  # the engine the program picked: align, screen, topk
    setup_s: float
    window_s: float  # host clock, first batch sent to last one answered
    latencies: list  # seconds of every batch of the window
    batches: int
    attempted: int
    failed: int
    segments: int  # audio segments embedded in the window
    spans: dict  # span name -> host seconds of each call
    launches: int  # align-reduce launches in the window
    escalated: int | None  # queries the screen's stage 3 rescored
    trace: object | None  # fpbench.trace.Trace of a --trace 1 window
    # fpbench.program_trace.ProgramTrace of a --trace 1 window, where the
    # program records spans
    program: object | None = None


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_of(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics a cell reports: those that list
    it, or that list no cells (a per-layer metric: every cell that reports
    the metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit("no workload %r in BENCHMARK.json" % name)
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    e2e, layer = metrics_of(bench, name)
    return Cell(
        name=name,
        chips=entry["chips"],
        config=load_json(os.path.join(root, config["file"])),
        traffic=load_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json")),
        limits=load_json(os.path.join(HERE, "workloads", name + ".json"))["limits"],
        end_to_end=e2e,
        per_layer=layer,
    )


def read_metric(name: str, reading: Reading):
    """The value of one metric from its reader, or None where it finds
    nothing to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("fpbench_metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(reading)


def process_start() -> float:
    """Epoch seconds at which this process started (Linux), else the import
    of this module."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def write_db(root: str, cfg: dict, inputs: generate.Inputs, n_src: int, device) -> dict:
    """The catalogue as a DB directory the program's loaders read; audio
    source songs' rows through the program's ``Embedder.embed_songs`` (the
    builder's path).  Returns the seconds of each step."""
    from pfann_tpu_torch.index.database import MODEL_FILE_NAME, write_index_meta
    from pfann_tpu_torch.index.embedder import Embedder
    from pfann_tpu_torch.utils.checkpoint import save_model

    sec = {}
    t = time.perf_counter()
    with open(os.path.join(root, "configs.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    n_songs, C, d = inputs.catalogue.shape
    if inputs.params is not None:
        save_model(os.path.join(root, MODEL_FILE_NAME),
                   {k: v.cpu() for k, v in inputs.params.items()})
        # the builder's Embedder, with its default chunk (builder.py): the
        # matcher's chunk of 2,048 packs 68 songs of 120 windows into one call
        # of 8,228 segments, past which the card's embeddings go wrong
        # (PERF.md, Open questions)
        emb = Embedder(cfg, os.path.join(root, MODEL_FILE_NAME), device)
        signals = list(inputs.source_audio.cpu().numpy())
        sync(device)
        t1 = time.perf_counter()
        rows = emb.embed_songs(signals, [C] * n_src, generate.hop_samples(cfg))
        inputs.catalogue[:n_src] = np.stack(rows)
        sec["embed_source_s"] = time.perf_counter() - t1
        del emb, signals, rows
    inputs.catalogue.tofile(os.path.join(root, "embeddings"))
    np.full(n_songs, C, np.int32).tofile(os.path.join(root, "landmarkKey"))
    with open(os.path.join(root, "songList.txt"), "w") as f:
        f.writelines("song%06d.wav\n" % i for i in range(n_songs))
    write_index_meta(root, d=d)
    sec["db_write_s"] = time.perf_counter() - t - sec.get("embed_source_s", 0.0)
    return sec


def program_tracer():
    """The program's span recorder (``pfann_tpu_torch.utils.profiling``),
    or None where the program has none."""
    try:
        from pfann_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "enable") else None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's fields (and, with
    ``control``, the control's readings of the same inputs)."""
    from pfann_tpu_torch.index import align_kernel
    from pfann_tpu_torch.index.database import Database
    from pfann_tpu_torch.matcher import load_model_and_db

    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    if int(cfg["indexer"].get("frame_shift_mul", 1)) != 1:
        raise ValueError("the reference compares frame_shift_mul 1 only")
    audio = tr["kind"] == "audio"
    setup = {"import_s": time.time() - t_start}
    t = time.perf_counter()
    inputs = generate.make_inputs(cfg, tr, seed, device)
    sync(device)
    setup["data_s"] = time.perf_counter() - t
    db_dir = tempfile.mkdtemp(prefix="fpbench-db-")
    try:
        setup.update(write_db(db_dir, cfg, inputs, tr.get("source_songs", 0), device))
        t = time.perf_counter()
        if audio:
            embedder, db, _ = load_model_and_db(db_dir, device)
        else:
            embedder, db = None, Database(db_dir, cfg["indexer"], cfg["hop_size"], device)
        sync(device)
        setup["load_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(db_dir, ignore_errors=True)

    B, S, P = tr["batch"], tr["query_rows"], tr["pool"]
    hop = generate.hop_samples(cfg)
    pool, order = inputs.pool, inputs.order
    spans = Spans(trace)
    cursor = 0

    def step():
        """One batch: (pool indices, song [B], time s [B], score [B])."""
        nonlocal cursor
        idx = order[(cursor + np.arange(B)) % P]
        cursor += B
        queries = [pool[i] for i in idx]
        if audio:
            with spans("embed"):
                queries = embedder.embed_songs(queries, [S] * B, hop)
        with spans("search"):
            answers = db.query_top1_batch(queries)
        if len(answers) != B:
            raise RuntimeError("%d answers to %d queries" % (len(answers), B))
        return (idx, np.array([a[1][0] for a in answers], np.int64),
                np.array([a[1][1] for a in answers], np.float64),
                np.array([a[0] for a in answers], np.float64))

    errors = 0

    def serve():
        """``step``, with a batch that raises answered by -1 for every query."""
        nonlocal errors
        try:
            return step()
        except Exception:
            if errors == 0:
                traceback.print_exc()
            errors += 1
            return (order[(cursor - B + np.arange(B)) % P], np.full(B, -1, np.int64),
                    np.zeros(B), np.zeros(B))

    t = time.perf_counter()
    for _ in range(WARMUP_BATCHES):
        serve()
    sync(device)
    setup["warmup_s"] = time.perf_counter() - t
    spans.seconds.clear()

    engine = getattr(db, "engine", "?")
    screen = getattr(db, "_align", None)
    esc0 = getattr(screen, "escalated", None)
    launches0 = align_kernel.align_reduce.launches
    prof = None
    tracer = program_tracer() if trace else None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        if tracer is not None:
            tracer.enable()
    lat, got, failed = [], [], 0
    t_first = time.perf_counter()
    setup_s = time.time() - t_start
    deadline = t_first + seconds
    t_done = t_first
    try:
        with (torch.profiler.record_function(WINDOW) if trace else contextlib.nullcontext()):
            while True:
                t0 = time.perf_counter()
                if t0 >= deadline:
                    break
                idx, song, tsec, score = serve()
                t_done = time.perf_counter()
                lat.append(t_done - t0)
                failed += int((song < 0).sum())
                got.append((idx, song, tsec, score))
            sync(device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if tracer is not None:
            tracer.disable()
    window_s = t_done - t_first
    launches = align_kernel.align_reduce.launches - launches0
    escalated = None if esc0 is None else screen.escalated - esc0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    segments = len(lat) * B * (S if audio else 0)
    del embedder, db, screen
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    answers = {k: np.concatenate([g[j] for g in got])
               for j, k in enumerate(("idx", "song", "time_s", "score"))}
    tr_read = program = None
    t = time.perf_counter()
    if prof is not None:
        records = tracer.records() if tracer is not None else []
        tr_read = read_trace(prof, {r.name for r in records})
        if tracer is not None:
            program = program_trace.read(prof, records)
    read_s = time.perf_counter() - t
    del prof
    check = compare(cfg, tr, inputs, answers, device, cell.limits, control=control)
    hits = hit_share(cfg, inputs, answers)
    reading = Reading(
        cell=cell, engine=engine, setup_s=setup_s, window_s=window_s, latencies=lat,
        batches=len(lat), attempted=len(lat) * B, failed=failed, segments=segments,
        spans=dict(spans.seconds), launches=launches, escalated=escalated,
        trace=tr_read, program=program,
    )
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = read_metric(m["name"], reading)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out = {
        "correct": check["correct"],
        "attempted": reading.attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if tr_read is not None:
        dev["busy_s"] = tr_read.busy_s
        dev["window_s"] = tr_read.window_s
        # idle gaps by the program's span where it recorded them
        gaps = (program if program is not None else tr_read).idle_gaps
        out["breakdown"] = {"device_ops": tr_read.device_ops, "idle_gaps": gaps}
    info = {
        "cell": cell.name, "seed": seed, "engine": engine, "setup": setup,
        "batches": len(lat), "batch_errors": errors, "hit_share": hits,
        "escalated": escalated, "launches": launches, "window_s": window_s,
        "checked": check["checked"], "components": check["components"],
    }
    if tr_read is not None:
        info["trace_read_s"] = read_s
        info["idle_by_span"] = tr_read.idle_by_span
        info["device_activities"] = tr_read.activities
    if program is not None:
        info["program_spans"] = program_trace.span_table(tracer.summary(program.records),
                                                         program)
        info["idle_by_program_span"] = program.idle_by_span
        info["program_dropped"] = tracer.dropped()
        # device seconds launched outside every program span
        info["program_unattributed_s"] = program.device_by_span.get(
            program_trace.UNATTRIBUTED, 0.0)
    if control:
        info["control"] = check["control"]
    out["info"] = info
    out["checks"] = check["checks"]
    return out


def hit_share(cfg: dict, inputs: generate.Inputs, answers: dict) -> float:
    """Share of the window's answers that name the query's source song at
    its offset."""
    truth = inputs.truth[answers["idx"]]
    t = np.rint(answers["time_s"] / cfg["hop_size"])
    ok = (answers["song"] == truth[:, 0]) & (t == truth[:, 1])
    return float(ok.mean()) if ok.size else 0.0


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(out: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    info, checks = out.pop("info"), out.pop("checks")
    print("fpbench " + json.dumps(info), flush=True)
    for name, c in checks.items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    out["card"] = info.get("card", "")
    out["checks"] = checks
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("fpbench: %d CUDA cards visible, the cell needs %d; a run measures "
              "the card only" % (torch.cuda.device_count() if torch.cuda.is_available()
                                 else 0, cell.chips), file=sys.stderr)
        return 2
    card = card_name()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   t_start)
    out["info"]["card"] = card
    bad = forbidden_modules()
    if bad:
        print("fpbench: the run loaded %s" % ", ".join(bad), file=sys.stderr)
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
