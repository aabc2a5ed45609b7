"""One run of one benchmark cell of pointrcnn_tpu_torch on one H100.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's program (``BENCHMARK.json`` names its configuration and
traffic mix; the mix's ``step`` names a built-in step or a step module
``steps/<step>.py``, ``harness/spec.py``) from the seed, runs its first
steps (set-up: imports, kernel builds, weights, the scene pool, warm-up),
drives the measured window for ``--seconds``, has the step's check compare
the window's outputs with its plain reference, and prints one JSON line
last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read by
``metrics/<name>.py``), ``device`` and, traced, ``breakdown``; the numbers
compared come last in that line and, beside their limits, as the last
lines on standard error.  ``correct`` is the harness's verdict on the
step's numbers (``check.verdict``) and the window's failed steps, for
every step.

Needs a CUDA card: without one it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = BENCH / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "pointrcnn_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def end_to_end(name: str, d, peak: int, setup_s: float):
    """The value of end-to-end metric ``name`` for the window of driver ``d``."""
    import numpy as np

    if name in ("eval_frames_s", "train_frames_s", "rcnn_train_frames_s"):
        return d.frames / d.window_s
    if name == "eval_batch_p95_ms":
        return float(np.percentile(np.array(d.step_s) * 1e3, 95))
    if name == "peak_mem_gib":
        return peak / 2 ** 30
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r}")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: needs {cell.chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line, rows = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for k, v, lim in rows:
        print(f"compared {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def execute(cell, seed: int, seconds: float, traced: bool, device: str):
    """Set-up, window and output check of one run of ``cell`` on
    ``device`` -> (the result line, [(number, value, limit)]).  The tests
    drive it on the CPU (untraced); a run measures on the card."""
    import torch

    from benchmark.harness import check, spans, spec, trace
    from pointrcnn_tpu_torch.ops import counts

    on_card = torch.device(device).type == "cuda"
    step = spec.load_step(cell.traffic["step"], cell.bench)
    overrides = list(cell.traffic.get("overrides", []))
    cfg = step.load_config(str(cell.config_path), overrides)
    d = step.Driver(cell, cfg, seed, device)
    d.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    readers = []
    if traced:
        d.spans = spans.Spans()
        for m in cell.per_layer:
            r = spec.load_reader(m["name"], cell.bench)
            r.install(d)
            readers.append((m, r))
        counts.reset()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    d.window(seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if traced:
        launches = counts.read()
        d.span_ms = {n: d.spans.total_ms(n) for n in list(d.spans.events)}
        d.window_calls = {n: list(v) for n, v in d.spans.calls.items()}
        d.spans.clear()
        d.trace = {**trace.profiled(d.extra, step.PROFILED_STEPS),
                   "steps": step.PROFILED_STEPS}
        d.spans.remove()
    steps_ms = sorted(1e3 * s for s in d.step_s)
    print(json.dumps({"steps": len(steps_ms), "step_ms_median": steps_ms[len(steps_ms) // 2],
                      "step_ms_min": steps_ms[0], "step_ms_max": steps_ms[-1],
                      "window_s": d.window_s, "frames": d.frames,
                      "card": card_limit() if on_card else device,
                      **({"launches": launches} if traced else {})}), flush=True)

    metrics = {}
    if traced:
        for m, r in readers:
            v = r.read(d)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(end_to_end(m["name"], d, peak, setup_s)),
                                  "unit": m["unit"]}

    # the output check, once the window has closed and the program is freed
    numbers = step.check(d, cell, overrides)
    correct, rows = check.verdict(numbers, cell.limits)
    correct = correct and d.failed == 0

    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        device_rec.update(busy_s=d.trace["busy_s"], window_s=d.trace["window_s"])
    line = {"correct": correct, "attempted": d.attempted, "failed": d.failed,
            "metrics": metrics, "device": device_rec}
    if traced:
        line["breakdown"] = {"device_ops": d.trace["device_ops"],
                             "idle_gaps": d.trace["idle_gaps"]}
    line["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return line, rows


if __name__ == "__main__":
    sys.exit(main())
