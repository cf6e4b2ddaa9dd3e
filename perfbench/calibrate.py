"""The readings a cell's limits are set from, on the chip at the cell's
own size, in one process (the kernels are built and loaded once):

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control 3 --out chiprun_out/<cell>.jsonl

For each seed: the program's readings over the checked steps against the
reference's (the lower readings).  For the first ``--control`` seeds
also: the reference computed with its bfloat16 products in float8
(``reference.fp8_cast``) put in the program's place (the control), and
the program with each planted fault of ``faults.py`` but ``unchanged``,
which reads 1 by the measure and needs no run.  One JSON line a reading,
with both sides' first global gradient norm beside the clip; the
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import faults, judge, reference, spec, train_cell
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(args.workload, ROOT)
    dev = torch.device("cuda", 0)
    model, traffic = cell["model"], cell["traffic"]
    with open(args.out, "a") as out:
        def emit(seed, kind, prog, ref, t0):
            row = {"workload": args.workload, "seed": seed, "kind": kind,
                   "numbers": judge.numbers(prog, ref),
                   "losses": prog["losses"], "ref_losses": ref["losses"],
                   "grad_norm": prog["grad_norm"],
                   "ref_grad_norm": ref["grad_norm"],
                   "grad_clip": traffic["optimizer"]["grad_clip"],
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), file=out, flush=True)
            print(json.dumps(row), flush=True)

        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            prog = train_cell.program_readings(cell, seed, dev)
            t1 = time.perf_counter()
            ref = reference.readings(model, traffic, seed, dev)
            emit(seed, "program", prog, ref, t0)
            print(f"calibrate: program {t1 - t0:.1f} s, reference "
                  f"{time.perf_counter() - t1:.1f} s", file=sys.stderr)
            if i >= args.control:
                continue
            t0 = time.perf_counter()
            ctrl = reference.readings(model, traffic, seed, dev,
                                      reference.fp8_cast)
            emit(seed, "control_fp8", ctrl, ref, t0)
            for name in ("half_batch", "double_leaf", "no_clip"):
                t0 = time.perf_counter()
                with faults.FAULTS[name]():
                    bad = train_cell.program_readings(cell, seed, dev)
                emit(seed, f"fault_{name}", bad, ref, t0)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
