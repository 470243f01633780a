"""One run of one benchmark cell of ``spurfies_tpu_torch`` on the card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It sets the cell up from the seed, warms it
up, measures for ``--seconds``, optionally traces a further window, checks
what the timed path produced against the plain reference
(``benchmark/plain``), and prints one JSON line last on standard output.
It exits with 2, printing no result, without enough CUDA cards, without
the program, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.load_json(Path.cwd() / "BENCHMARK.json")
    spec = harness.cell_spec(bench, args.workload)
    import torch
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import spurfies_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    run, result = harness.run_cell(spec, args.seed, args.seconds,
                                   bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 2
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
    result["device"] = device
    result["compared"] = harness.compared_text(run.compared)
    for name, v, lim in run.compared:
        print(f"compared {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
