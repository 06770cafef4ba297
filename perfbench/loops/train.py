"""The training loop: one train state built at set-up, driven through its
first steps (the ones the reference follows) by the window's own call and
feed, then handed to the window, which takes steps back to back until the
window's seconds have passed; the window ends when its last step completes.

``train_step_s`` is the window's length over its steps; ``train_peak_gib``
the most memory allocated in the window. With ``--trace 1`` the window's
first two steps run under the profiler and the span timings come from the
steps after them.

The check: each checked step's loss, the norm of the first step's gradient
as the optimizer took it (from its first moment), the norm of each
parameter's change over the checked steps, and the cosine between the
program's change and the reference's (so a change of the right size in the
wrong direction, or in the wrong leaf, fails), leaf by leaf,
against the float32 reference taking the same steps on the same batches and
draws. The program's change is held on the host in bfloat16 until the
reference has run.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback

import torch

from perfbench.harness import checks, env, trace
from perfbench.loops.request import read_per_layer
from perfbench.roofline import peaks


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def change_norms(params: dict, start: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(params[k].detach().double() - start[k].double()))
            for k in params}


def changes(params: dict, start: dict) -> dict:
    """Each leaf's change, in bfloat16 on the host."""
    return {k: (params[k].detach().float() - start[k].float()).to(torch.bfloat16).cpu()
            for k in params}


def cosines(params: dict, start: dict, other: dict) -> dict:
    """Each leaf's cosine between its change (params − start) and ``other``
    (a change from ``changes``); 0 where either is nought."""
    out = {}
    for k in params:
        d = params[k].detach().double() - start[k].double()
        o = other[k].to(d.device).double()
        den = float(torch.linalg.vector_norm(d) * torch.linalg.vector_norm(o))
        out[k] = float((d * o).sum()) / den if den > 0 else 0.0
    return out


def program_readings(system, traffic: dict, seed: int, trainer, steps: int) -> dict:
    """The program's checked steps through the window's own call and feed."""
    losses, first = [], None
    for i in range(steps):
        losses.append(system.train_step(trainer, system.make_batch(traffic, seed, i))["loss"])
        if i == 0:
            first = leaf_norms(system.first_gradients(trainer))
    start = system.draw(seed)["unet"]
    masters = system.masters(trainer)
    return {"losses": losses, "grads": first, "changes": change_norms(masters, start),
            "deltas": changes(masters, start)}


def reference_readings(system, traffic: dict, seed: int, steps: int,
                       numerics: str = "fp32", against: dict | None = None) -> dict:
    """The same steps, batches and draws through the plain reference; with
    ``against`` (another side's ``deltas``), each leaf's cosine with it."""
    weights = system.draw(seed)
    ref = system.train_reference(weights, numerics)
    start = weights["unet"]
    del weights
    gen = torch.Generator(device=system.device).manual_seed(int(seed) % 2**63)
    losses, first = [], None
    for i in range(steps):
        loss, grads = ref.step(system.make_batch(traffic, seed, i), gen)
        losses.append(loss)
        if i == 0:
            first = leaf_norms(grads)
        del grads
    out = {"losses": losses, "grads": first, "changes": change_norms(ref.params, start)}
    if against is not None:
        out["cos"] = cosines(ref.params, start, against)
    else:
        out["deltas"] = changes(ref.params, start)
    return out


def compare(got: dict, want: dict, share: float) -> dict:
    """Each checked step's loss; the worst leaf's first gradient, change and
    direction of change, 1 − cos (``want`` read ``against`` ``got``'s
    deltas), each scaled as ``checks.leaf_worst`` scales a gap."""
    return {
        "loss_rel": checks.worst(abs(a - b) / abs(b)
                                 for a, b in zip(got["losses"], want["losses"])),
        "grad_leaf_gap": checks.leaf_gap(got["grads"], want["grads"], want["grads"], share),
        "update_leaf_gap": checks.leaf_gap(got["changes"], want["changes"], want["grads"],
                                           share),
        "update_leaf_cos": checks.leaf_worst(
            {k: (1.0 - cos) * want["changes"][k] for k, cos in want["cos"].items()},
            want["changes"], want["grads"], share),
    }


def run(*, args, spec, traffic, system, end_to_end, per_layer, t0, overrides) -> dict:
    dev = system.device
    seed, traced = args.seed, bool(args.trace)
    n_checked = spec["check"]["steps"]

    # -- set-up: the train state, driven through the checked steps --------------
    marks = [("imports", time.perf_counter())]
    weights = system.draw(seed)
    _sync(dev)
    marks.append(("weights", time.perf_counter()))
    trainer = system.build_trainer(weights, seed)
    del weights
    if overrides.get("program_patch"):
        trainer = overrides["program_patch"](trainer) or trainer
    _sync(dev)
    marks.append(("train state", time.perf_counter()))
    got = program_readings(system, traffic, seed, trainer, n_checked)
    marks.append((f"{n_checked} checked steps", time.perf_counter()))
    spans = trace.Spans()
    if traced:
        for target in system.trainer_spans():
            spans.function(*target)
    gc.collect()
    _sync(dev)
    setup_s = time.perf_counter() - t0
    print(f"perfbench: set-up {setup_s:.2f} s: " + ", ".join(
        f"{name} {t - prev:.2f}" for (name, t), prev in zip(marks, [t0] + [t for _, t in marks])),
        file=sys.stderr)

    # -- the window ---------------------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    steps, attempted, failed = 0, 0, 0
    holder, after_profiled, profiled_s, counters = {}, None, None, None
    index = n_checked
    state_before = env.card_state() if dev.type == "cuda" else ""
    ends = []
    start = time.perf_counter()
    deadline = start + args.seconds
    while time.perf_counter() < deadline:
        try:
            if traced and attempted == 0:
                before = trace.launch_counters()
                t_prof = time.perf_counter()
                with trace.profiled("steps") as holder:
                    for _ in range(2):
                        system.train_step(trainer, system.make_batch(traffic, seed, index))
                        index += 1
                        attempted += 1
                        steps += 1
                counters = {k: v - before.get(k, 0) for k, v in trace.launch_counters().items()}
                spans.clear()
                after_profiled = time.perf_counter()
                profiled_s = after_profiled - t_prof
                continue
            attempted += 1
            system.train_step(trainer, system.make_batch(traffic, seed, index))
            index += 1
            _sync(dev)
            steps += 1
            ends.append(time.perf_counter())
        except Exception:  # a failed step is counted, and the run is not correct
            failed += 1
            traceback.print_exc(file=sys.stderr)
    end = time.perf_counter()
    print(f"perfbench: steps done at {[round(t - start, 3) for t in ends]} s; card "
          f"(clock, power, temperature) {state_before} before, "
          f"{env.card_state() if dev.type == 'cuda' else ''} after", file=sys.stderr)
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics, device_extra, breakdown = {}, {}, None
    if traced:
        prof = holder["reduce"]()
        launched = sum(counters.values())
        if prof.program_kernels() < launched:
            raise RuntimeError(f"the trace holds {prof.program_kernels()} of the program's "
                               f"kernels, its launch counters {launched}: records were lost")
        spans.active = False
        unprofiled = steps - 2
        item_s = 2 * (end - after_profiled) / unprofiled if unprofiled > 0 else None
        if item_s:
            print(f"perfbench: the two profiled steps took {profiled_s:.3f} s, "
                  f"{prof.window_s:.3f} s in their trace, against {item_s:.3f} s for two "
                  f"unprofiled: the profiler's host cost stretches them "
                  f"{prof.window_s / item_s:.2f} times", file=sys.stderr)
        records = {
            "kind": "train", "profile": prof, "counters": counters, "calls": {},
            "spans": {name: spans.ms(name) for name in list(spans.events)},
            "peak_flops": peaks.BF16_FLOPS,
            "item_s": item_s,
            "item_flops": 2 * system.step_flops(traffic) if unprofiled > 0 else None,
        }
        metrics = read_per_layer(per_layer, records)
        device_extra = {"busy_s": prof.busy_s, "window_s": prof.window_s}
        breakdown = {"device_ops": prof.top_ops(), "idle_gaps": prof.idle_gaps()}
    else:
        names = {m["name"] for m in end_to_end}
        if "train_step_s" in names and steps:
            metrics["train_step_s"] = {"value": (end - start) / steps, "unit": "s"}
        if "train_peak_gib" in names and dev.type == "cuda":
            metrics["train_peak_gib"] = {"value": window_peak / 2**30, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    spans.remove()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # -- the check, outside every timed number ---------------------------------
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = reference_readings(system, traffic, seed, n_checked, against=got.pop("deltas"))
    numbers = compare(got, want, spec["check"]["min_leaf_share"])
    print(f"perfbench: {n_checked} steps checked against the reference in "
          f"{time.perf_counter() - t_ref:.1f} s; losses {got['losses']} against "
          f"{want['losses']}", file=sys.stderr)
    ok, table = checks.judge(numbers, spec["limits"])
    result = {"correct": bool(ok and failed == 0 and steps > 0), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {**(env.device_record(1, peak) if dev.type == "cuda"
                            else {"platform": "cpu", "kind": "cpu", "count": 1,
                                  "memory_peak_bytes": 0}), **device_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    return result
