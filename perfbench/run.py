"""The benchmark of `avsi_torch` on one NVIDIA H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  Looks the cell up in `BENCHMARK.json`,
runs its traffic mix's loop (`perfbench/loops/<loop>.py`) against the
program, checks what the timed path produced against the plain reference
(`perfbench/reference/`), and prints one JSON line last on standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with
`--trace 1` a `breakdown`, and last the `checks`, each number compared
with its limit (also the last lines of standard error).  Without a CUDA
card, or with fewer cards than the cell asks for, it exits with 2 and
prints no result.  Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "avsi")  # top-level module names, compared whole


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout, for every compiler the
    program or PyTorch may run (the port's own kernels build into
    `build/avsi_torch/` beside the package)."""
    base = root / "build" / "perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, rehearsal: dict | None = None, t0: float | None = None) -> int:
    """`rehearsal` (tests only): run on the CPU at the sizes it gives;
    the command line never sets it."""
    args = parse(argv)
    cache_env(ROOT)
    from perfbench.lib import spec
    from perfbench.lib.outcome import Run

    bench = spec.load_benchmark(ROOT)
    cell, config, traffic = spec.cell_files(bench, args.workload, ROOT)

    import torch

    if rehearsal is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"perfbench: the cell needs {cell['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
        config = {**config, "model": {**config["model"], **rehearsal.get("model", {})}}
        traffic = {**traffic, **rehearsal.get("traffic", {})}

    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        run = Run(cell, config, traffic, args.seed, args.seconds, bool(args.trace), device, tmp,
                  T0 if t0 is None else t0)
        out = spec.loop_module(traffic).run(run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found} (JAX or the JAX package)", file=sys.stderr)
        return 3

    metrics = {}
    if not args.trace:
        for m in bench["end_to_end"]:
            if spec.applies(m, cell["name"]):
                metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if spec.applies(m, cell["name"]):
                value = spec.metric_reader(m["name"])(out.layer, run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    correct = bool(out.attempted > 0 and out.failed == 0
                   and all(v <= lim for v, lim in out.checks.values()))
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    trace = out.layer.get("trace")
    if args.trace and trace is not None:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}

    notes = dict(out.notes, card=card_line() if device.type == "cuda" else "cpu")
    print("perfbench notes: " + json.dumps(notes), file=sys.stderr)
    for k, (v, lim) in out.checks.items():
        print(f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
