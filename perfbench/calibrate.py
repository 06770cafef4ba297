"""The readings that a cell's limits are set from, on the card at the cell's
own sizes, in one process:

- the program: for each seed, the weights drawn, the program built, one
  request of the cell's traffic through its timed entry, then (the
  program freed) the check against the float32 reference;
- the control: for each control seed, the reference itself computed with
  every product's operands rounded through fp8 e4m3 put in the program's
  place, its whole request judged by the same check.

    python3 perfbench/calibrate.py --workload a512.request --seeds 101-112 --control 201-203
    python3 perfbench/calibrate.py --workload a512.train_b4 --seeds "" --control "" \
        --faults half_batch,altered_answer --fault-seeds 701-703

Each reading is a JSON line on standard output and in
``chiprun_out/calibration.<cell>.jsonl``. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench.harness import env, registry  # noqa: E402


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def program_reading(system, traffic, spec, seed):
    weights = system.draw(seed)
    program = system.build_program(weights)
    del weights
    capture = system.capture(program)
    req = system.make_request(traffic, seed, 0)
    t = time.perf_counter()
    capture.begin()
    capture.finish(system.run_request(program, req))
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t
    rec = capture.record
    capture.remove()
    del capture, program
    gc.collect()
    torch.cuda.empty_cache()
    ref = system.reference(system.draw(seed))
    with torch.no_grad():
        nums = system.check(ref, req, rec, spec["check"])
    return nums, request_s


def train_program_reading(system, traffic, spec, seed, fault=None):
    from perfbench import faults
    from perfbench.loops import train

    t = time.perf_counter()
    trainer = system.build_trainer(system.draw(seed), seed)
    undo = faults.plant("train", fault, trainer) if fault else None
    try:
        got = train.program_readings(system, traffic, seed, trainer, spec["check"]["steps"])
    finally:
        if undo:
            undo()
    step_s = time.perf_counter() - t
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    want = train.reference_readings(system, traffic, seed, spec["check"]["steps"],
                                    against=got.pop("deltas"))
    return train.compare(got, want, spec["check"]["min_leaf_share"]), step_s


def train_control_reading(system, traffic, spec, seed):
    from perfbench.loops import train

    got = train.reference_readings(system, traffic, seed, spec["check"]["steps"], "fp8")
    want = train.reference_readings(system, traffic, seed, spec["check"]["steps"],
                                    against=got.pop("deltas"))
    return train.compare(got, want, spec["check"]["min_leaf_share"])


def control_reading(system, traffic, spec, seed):
    ref = system.reference(system.draw(seed))
    control = system.reference(system.draw(seed), numerics="fp8")
    req = system.make_request(traffic, seed, 0)
    with torch.no_grad():
        rec = control.run(req, system.device)
        del control
        return system.check(ref, req, rec, spec["check"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="101-112")
    p.add_argument("--control", default="201-203")
    p.add_argument("--faults", default="", help="training faults to read, e.g. half_batch")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    env.set_cache_dirs()
    env.require_cards(1)
    spec = registry.workload(args.workload)
    system = registry.config_module(spec["config"]).System(registry.config(spec["config"]),
                                                            "cuda")
    traffic = registry.traffic(spec["traffic"])
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    log = open(out / f"calibration.{args.workload}.jsonl", "a")
    ident = {"kind": torch.cuda.get_device_name(0), "power_limit": env.power_limit()}
    train = spec["loop"] == "train"
    for side, seed_list, fn in (
            ("program", seeds(args.seeds), train_program_reading if train else program_reading),
            ("control", seeds(args.control), train_control_reading if train else control_reading)):
        for seed in seed_list:
            t = time.perf_counter()
            result = fn(system, traffic, spec, seed)
            extra = {}
            if side == "program":
                result, extra["request_s"] = result
            row = {"cell": args.workload, "side": side, "seed": seed, "numbers": result,
                   "seconds": time.perf_counter() - t, **extra, **ident}
            print(json.dumps(row), flush=True)
            log.write(json.dumps(row) + "\n")
            log.flush()
            gc.collect()
            torch.cuda.empty_cache()
    for fault in filter(None, args.faults.split(",")):
        for seed in seeds(args.fault_seeds):
            result, _ = train_program_reading(system, traffic, spec, seed, fault)
            row = {"cell": args.workload, "side": f"fault:{fault}", "seed": seed,
                   "numbers": result, **ident}
            print(json.dumps(row), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
