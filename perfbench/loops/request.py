"""The closed loop of one client: requests back to back until the window's
seconds have passed, each drawn from the seed and its index; the window ends
when the last request started in it completes.

``request_s`` is the window's length over the requests completed in it.
With ``--trace 1`` the first request of the window runs under the profiler
and the span timings are read from the requests after it.

The request that the check judges is drawn from the seed by a reservoir of
one: before the n-th request to complete (from 0) is sent, a draw of 1 in
n + 1 marks it to replace the one kept, so the kept request is uniform over
those completed and only its record is held through the window.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np
import torch

from perfbench.harness import checks, env, registry, trace
from perfbench.roofline import peaks


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def install_rooflines(per_layer: list, calls: trace.Calls) -> None:
    """Wrap each roofline function that a per-layer metric of the cell
    names (``<function>_roofline``) where the program calls it."""
    import importlib

    for m in per_layer:
        if not m["name"].endswith("_roofline"):
            continue
        fn = m["name"][:-len("_roofline")]
        roof = registry.roofline_module(fn)
        for modname, attr in roof.CALLERS:
            try:
                owner = importlib.import_module(modname)
            except ImportError:
                continue
            if hasattr(owner, attr):
                calls.wrap(fn, owner, attr, roof.bound_s)


def read_per_layer(per_layer: list, records: dict) -> dict:
    out = {}
    for m in per_layer:
        value = registry.metric_module(m["name"]).read(records)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(*, args, spec, traffic, system, end_to_end, per_layer, t0, overrides) -> dict:
    dev = system.device
    seed, traced = args.seed, bool(args.trace)

    # -- set-up: weights, program, the cell's shapes warmed -------------------
    marks = [("imports", time.perf_counter())]
    weights = system.draw(seed)
    _sync(dev)
    marks.append(("weights", time.perf_counter()))
    program = system.build_program(weights)
    del weights
    if overrides.get("program_patch"):
        program = overrides["program_patch"](program) or program
    _sync(dev)
    marks.append(("program", time.perf_counter()))
    system.run_request(program, system.make_request(traffic, seed, -1))
    _sync(dev)
    marks.append(("warm-up request", time.perf_counter()))
    capture = system.capture(program)
    spans, calls = trace.Spans(), trace.Calls()
    if traced:
        for target in system.span_targets(program):
            if isinstance(target[1], torch.nn.Module):
                spans.module(target[0], target[1])
            else:
                spans.function(*target)
        install_rooflines(per_layer, calls)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    print(f"perfbench: set-up {setup_s:.2f} s: " + ", ".join(
        f"{name} {t - prev:.2f}" for (name, t), prev in zip(marks, [t0] + [t for _, t in marks])),
        file=sys.stderr)

    # -- the window -------------------------------------------------------------
    done, attempted, failed = 0, 0, 0
    kept, pick = None, np.random.default_rng([int(seed) % 2**63, 0])
    holder, after_profiled, profiled_s, counters, call_bounds = {}, None, None, None, {}
    state_before = env.card_state() if dev.type == "cuda" else ""
    ends = []
    start = time.perf_counter()
    deadline = start + args.seconds
    while time.perf_counter() < deadline:
        req = system.make_request(traffic, seed, attempted)
        attempted += 1
        keep = int(pick.integers(done + 1)) == 0
        try:
            if traced and attempted == 1:
                before, mark = trace.launch_counters(), calls.mark()
                t_prof = time.perf_counter()
                with trace.profiled("request") as holder:
                    capture.begin(keep)
                    capture.finish(system.run_request(program, req))
                counters = {k: v - before.get(k, 0) for k, v in trace.launch_counters().items()}
                call_bounds = calls.since(mark)
                calls.remove()
                spans.clear()
                after_profiled = time.perf_counter()
                profiled_s = after_profiled - t_prof
            else:
                capture.begin(keep)
                capture.finish(system.run_request(program, req))
                _sync(dev)
            if keep:
                kept = (done, req)
            done += 1
            ends.append(time.perf_counter())
        except Exception:  # a failed request is counted, and the run is not correct
            failed += 1
            traceback.print_exc(file=sys.stderr)
    end = time.perf_counter()
    print(f"perfbench: requests done at {[round(t - start, 3) for t in ends]} s; card "
          f"(clock, power, temperature) {state_before} before, "
          f"{env.card_state() if dev.type == 'cuda' else ''} after", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # -- per-layer records --------------------------------------------------
    metrics, device_extra, breakdown = {}, {}, None
    if traced:
        prof = holder["reduce"]()
        launched = sum(counters.values())
        if prof.program_kernels() < launched:
            raise RuntimeError(f"the trace holds {prof.program_kernels()} of the program's "
                               f"kernels, its launch counters {launched}: records were lost")
        spans.active = False
        item_s = (end - after_profiled) / (done - 1) if done > 1 else None
        if item_s:
            print(f"perfbench: the profiled request took {profiled_s:.3f} s, "
                  f"{prof.window_s:.3f} s in its trace, against {item_s:.3f} s a request "
                  f"unprofiled: the profiler's host cost stretches it "
                  f"{prof.window_s / item_s:.2f} times", file=sys.stderr)
        records = {
            "kind": "request", "profile": prof, "counters": counters,
            "spans": {name: spans.ms(name) for name in list(spans.events)},
            "calls": call_bounds, "peak_flops": peaks.BF16_FLOPS,
            "item_s": item_s,
            "item_flops": system.request_flops(traffic) if done > 1 else None,
        }
        metrics = read_per_layer(per_layer, records)
        device_extra = {"busy_s": prof.busy_s, "window_s": prof.window_s}
        breakdown = {"device_ops": prof.top_ops(), "idle_gaps": prof.idle_gaps()}
    else:
        names = {m["name"] for m in end_to_end}
        if "request_s" in names and done:
            metrics["request_s"] = {"value": (end - start) / done, "unit": "s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    spans.remove()
    calls.remove()

    # -- the check, outside every timed number ---------------------------------
    numbers = {}
    if kept is not None:
        (k, req), rec = kept, capture.record
        capture.remove()
        del capture, program
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref = system.reference(system.draw(seed))
        with torch.no_grad():
            numbers = system.check(ref, req, rec, spec["check"])
        print(f"perfbench: request {k} of {done} checked against the reference in "
              f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    ok, table = checks.judge(numbers, spec["limits"])
    result = {"correct": bool(ok and failed == 0 and done > 0), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {**(env.device_record(1, peak) if dev.type == "cuda"
                            else {"platform": "cpu", "kind": "cpu", "count": 1,
                                  "memory_peak_bytes": 0}), **device_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    return result
