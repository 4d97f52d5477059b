"""The readings the limits of a cell's checks are set from: the program's
(the lower) and the control's (the upper), seed by seed, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 --seconds 8 \
        [--fault NAME[,NAME...]] [--out readings.jsonl]

For each seed it draws the cell's inputs, runs the cell's closed loop for
``--seconds`` at the cell's own sizes and load, and judges the answers
twice: as the program gave them, and with the plain reference put in the
program's place, computed in the precision below the one the cell's
configuration states (``reference.control_precision``: TF32 below
float32). That is the control, which has to come out not correct: for a
chain cell the reference sampler runs as many chains as the window
finished (at most ``--control_items``); for a bin, the reference filter,
loglik and GeneAssign take the program's filter, reported star loglik and
gene calls' place. One JSON line a seed. With ``--fault`` each fault
(``faults``) in turn is planted in the program, every seed is run under it
and only the program's readings are taken. The first run warms up; the
others reuse the built kernels. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import entries, run
from .faults import FAULTS


class Patch:
    """setattr that remembers what it replaced; undo puts it back."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()


def readings(name: str, seeds, seconds: float, device="cuda", bench=None, wl=None,
             config=None, log=print, control_items: int = 3, fault=None, warm=True):
    """One dict a seed: the program's numbers, the control's (none under a
    fault), whether each is within the cell's limits, and the items'
    seconds."""
    from . import reference
    from .judge import verdict

    bench, _, wl_, config_ = run.load(name, bench)
    wl, config = wl or wl_, config or config_
    prec = reference.control_precision(config["precision"])
    dev = torch.device(device)
    out = []
    for i, seed in enumerate(seeds):
        entry = entries.entry(wl["entry"])(wl, config, seed, dev)
        if warm and i == 0:
            entry.warm()
        window, item_s, sweeps, failed = run.loop(entry, seconds, None, log)
        entry.free()
        program = entry.judge()
        control = (entry.control(prec, min(max(len(item_s), 1), control_items))
                   if fault is None else {})
        entry.close()
        out.append({
            "workload": name, "seed": seed, "fault": fault, "items": len(item_s),
            "failed": failed,
            "item_s": item_s, "program": program, "control": control,
            "precision": prec.name,
            "program_correct": verdict(program, wl["limits"])[0] and not failed,
            "control_correct": verdict(control, wl["limits"])[0] if control else None,
        })
        log(json.dumps(out[-1]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control_items", type=int, default=3,
                    help="chains the reference sampler runs a seed (chain cells)")
    ap.add_argument("--fault", help="comma-separated faults (faults.FAULTS) to plant "
                    "in the program in turn; no control")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = args.fault.split(",") if args.fault else [None]
    unknown = set(faults) - set(FAULTS) - {None}
    if unknown:
        ap.error(f"no fault {sorted(unknown)}; known: {sorted(FAULTS)}")
    rows = []
    for i, fault in enumerate(faults):
        mp = Patch()
        if fault:
            FAULTS[fault](mp)
        try:
            rows += readings(args.workload, seeds, args.seconds,
                             control_items=args.control_items, fault=fault, warm=i == 0)
        finally:
            mp.undo()
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
