"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of `BENCHMARK.json` (its configuration, traffic and
chips), with `portbench/workloads/<cell>.json` (its driver and the limits
of its correctness numbers). Its configuration is
`portbench/configs/<config>.json`, its traffic `portbench/traffic/<mix>.json`
(read by `portbench/generate.py`), its driver `portbench/drivers/<driver>.py`,
and each per-layer metric is read by `portbench/metrics/<metric>.py`.
Which metrics a cell reports comes from `BENCHMARK.json`.

A run draws its weights and inputs from `--seed`, warms up, measures for
`--seconds`, checks what the timed path produced against the plain
reference (`portbench/reference/`), and prints one JSON object as the last
line of standard output: with `--trace 0` the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics from a traced run. The numbers
compared, each beside its limit, end standard error and the line. It
exits 2 without printing a result when the cell's cards are missing, and 3
when JAX or the JAX package was loaded.

A cell on more than one chip runs one process per card: this process is
rank 0 and starts the others (`--rank`), on a free local port.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)  # the checkout: the program's package sits here
sys.path[:0] = [HERE, ROOT]
# modules that must not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "vidil_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Context:
    """What a driver is handed: the cell, its configuration, the run's
    arguments, the device and the rank."""

    def __init__(self, args, workload, config, traffic, device, rank=0, world=1):
        self.args = args
        self.workload = workload
        self.config = config
        self.traffic = traffic
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.device = device
        self.rank = rank
        self.world = world
        self.t0 = T0
        self.tmp = os.environ.get("TMPDIR") or os.path.join(ROOT, ".portbench_tmp")
        self.fault = None      # a planted fault's name (tests and calibration)
        self.control = False   # also read the lower-precision control


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def set_env():
    """One host thread for the libraries' CPU pools (the host sets the
    pace of these cells, and spinning pool threads take its cores from the
    launching thread); caches inside the checkout, at fixed paths; no JAX
    through a library."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


def load_cell(bench: dict, name: str, workload=None, config=None, traffic=None):
    """The cell's entry in BENCHMARK.json, and by name its driver and limits
    (workloads/), its configuration (configs/) and its traffic (traffic/)."""
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    workload = workload or load_json(HERE, "workloads", f"{name}.json")
    config = config or load_json(HERE, "configs", f"{entry['config']}.json")
    traffic = traffic or load_json(HERE, "traffic", f"{entry['traffic']}.json")
    return entry, workload, config, traffic


def metric_names(bench: dict, cell: str, section: str) -> list[dict]:
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def start_ranks(argv, world, command=None):
    """Ranks 1..world-1 as processes of this script (or of `command`), each
    logging to a file under TMPDIR. Returns the processes."""
    command = command or [sys.executable, os.path.abspath(__file__)]
    port = free_port()
    tmp = os.environ.get("TMPDIR") or os.path.join(ROOT, ".portbench_tmp")
    os.makedirs(tmp, exist_ok=True)
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    procs = []
    for r in range(1, world):
        log = open(os.path.join(tmp, f"portbench_rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [*command, *argv, "--rank", str(r)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs, dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))


def stop_ranks(procs, timeout=300) -> list[int]:
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def result_line(bench, cell, out, trace, limits) -> dict:
    """The contract's object: correct, attempted, failed, metrics, device,
    breakdown (traced), and last the numbers compared with their limits."""
    metrics = {}
    if out["device"]["platform"] != "gpu":
        pass  # a run off the card (the benchmark's own tests) reports no timing
    elif trace:
        for m in metric_names(bench, cell, "per_layer"):
            reader = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                                 f"portbench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metric_names(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in out["checks"].items()}
    correct = (out["failed"] == 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": out["device"]}
    if trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None, *, device=None, bench=None, workload=None, config=None, traffic=None,
         hooks=None) -> int:
    """The run. The keywords are for the benchmark's own tests and its
    calibration: a device given here skips the look for cards, the four
    dicts stand in for BENCHMARK.json and the cell's files, and `hooks`
    plants a fault
    ("fault"), asks for the control ("control"), names the command of the
    other ranks ("rank_command") and receives the driver's output
    ("result")."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse(argv)
    set_env()
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    entry, workload, config, traffic = load_cell(bench, args.workload, workload, config, traffic)
    chips = entry["chips"]

    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {chips} CUDA device(s); found {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device)
    procs, saved_env = [], dict(os.environ)
    if chips > 1 and args.rank == 0:
        procs, rank_env = start_ranks(argv, chips, (hooks or {}).get("rank_command"))
        os.environ.update(rank_env)
    try:
        driver = load_module(os.path.join(HERE, "drivers", f"{workload['driver']}.py"),
                             f"portbench_driver_{workload['driver']}")
        ctx = Context(args, workload, config, traffic, device, args.rank, chips)
        ctx.fault = (hooks or {}).get("fault")
        ctx.control = (hooks or {}).get("control", False)
        out = driver.run(ctx, procs)
    except BaseException:
        for p in procs:
            p.kill()
        stop_ranks(procs)
        raise
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
    codes = stop_ranks(procs)
    if args.rank != 0:
        return 0
    if any(codes):
        print(f"portbench: a rank failed: exit codes {codes}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    line = result_line(bench, args.workload, out, args.trace, workload["limits"])
    if hooks is not None:
        hooks["result"] = out
    print(f"window: {out['attempted']} attempted; ms quartiles of each: {out['quartiles_ms']}",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
