"""One run of one benchmark cell of the PyTorch/CUDA port on the card.

    python3 perfbench/run.py --workload a512.request --seed 7 --seconds 51 --trace 0

Set-up (weights drawn on the card from the seed, the program built and its
cell's shapes warmed) counts from the process's start; then the window of
``--seconds``; then, outside every timed number, the check of what the
window produced against the plain reference. The last line of standard
output is the result's JSON; the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key. With
``--trace 1`` the metrics are the cell's per-layer metrics, read from one
profiled request or pair of steps early in the window.

The cell's pieces are found by name under this folder (``harness/registry.py``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import env, registry  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(args, device="cuda", overrides=None, t0=None) -> dict:
    """The run without its card check: the tests drive it on the CPU at a
    small size through ``overrides`` (``config`` / ``traffic`` entries
    merged over the files, ``program_patch`` applied to the built program)."""
    overrides = overrides or {}
    bench = registry.benchmark()
    try:
        spec = registry.workload(args.workload, bench)
    except KeyError as e:
        raise SystemExit(f"perfbench: {e.args[0]}") from None
    cfg = _merged(registry.config(spec["config"]), overrides.get("config"))
    traffic = _merged(registry.traffic(spec["traffic"]), overrides.get("traffic"))
    end_to_end, per_layer = registry.cell_metrics(args.workload, bench)
    loop = registry.loop_module(spec["loop"])
    system = registry.config_module(spec["config"]).System(cfg, device)
    return loop.run(args=args, spec=spec, traffic=traffic, system=system,
                    end_to_end=end_to_end, per_layer=per_layer, t0=T0 if t0 is None else t0,
                    overrides=overrides)


def _merged(base: dict, extra) -> dict:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = _merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def main(argv=None) -> int:
    args = parse(argv)
    env.set_cache_dirs()
    entry = next((w for w in registry.benchmark()["workloads"] if w["name"] == args.workload),
                 None)
    env.require_cards(entry["chips"] if entry else 1)
    result = execute(args)
    bad = env.forbidden_modules()
    if bad:
        print(f"perfbench: the process holds JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
