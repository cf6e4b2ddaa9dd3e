"""Run one cell of the benchmark once, on the chips of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up, a measured window of ``--seconds``
(with ``--trace 1``, traced steps after it), then the comparison with the
plain reference; the last line of standard output is the result as one
JSON object, and the last lines of standard error the numbers compared,
each beside its limit.  It exits with another code than 0, and prints no
result, where CUDA or the cell's chips are missing, where the program's
sources are not beside the benchmark, or where ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the compiled bytecode of every module the run imports (torch, sympy, the
# program), kept in the checkout at a fixed path, and written even where
# the environment turns writing off: only the first run in a checkout
# compiles the ~1,700 modules from their sources
PYCACHE = ROOT / "build" / "pycache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program's sources (src/repro_torch) are not "
              "beside the benchmark", file=sys.stderr)
        return 2
    import torch
    t_torch = time.perf_counter()
    from perfbench import harness, spec
    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} GPUs, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    harness.log(f"start: torch imported {t_torch - T_START:.2f} s, harness "
                f"and CUDA found {time.perf_counter() - t_torch:.2f} s")
    with tempfile.TemporaryDirectory(prefix="perfbench-") as scratch:
        result = harness.execute(cell, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0),
                                 T_START, scratch, ROOT)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded {found}, which the benchmark may not "
              "load", file=sys.stderr)
        return 3
    for line in harness.compare_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
