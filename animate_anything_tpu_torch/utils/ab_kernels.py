"""Kernels 3, 4, 7 and 11 of this checkout beside another checkout's (an
earlier commit, unpacked with ``git archive``) on one card, in turns: the
other, this, this, the other.

    python -m animate_anything_tpu_torch.utils.ab_kernels OTHER_DIR [--kernels 3,4,7,11]

Each turn is a process of its own that imports the package of its checkout
(its working directory) and builds that checkout's kernels there. It times,
through the public entry points both checkouts have, on the same seeded
inputs:

- kernel 3, ``tap_conv`` with the residual, at the UNet's four temporal-conv
  sites (``utils/kernel_sites.TAP_CONV_SITES``, b = 2, 17 frames), and
  kernel 4, ``proj_residual_stats``, at its five sites (``PROJ_SITES``, n =
  34): CUDA events around ten calls after three warm-up calls, and the
  device time of a call on the card's own clock (a spin kernel holds the
  stream while twenty calls are queued, as ``chip_smoke._device_ms``);
- kernel 7, ``group_norm_stream``, at the VAE's GroupNorm sites (a 512 px
  image encode and a 16-frame decode), and ``ln_qkv_attention`` at the
  UNet's three spatial self-attention sites: CUDA events as above, and the
  profiler's device time of a call (all its kernels, and for
  ``ln_qkv_attention`` kernel 11's and kernel 1's groups).

The sites are this checkout's, passed to both turns. Prints one line a site
and, last, one JSON object with every turn's numbers. Needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def measure(tap_sites, proj_sites, gn_sites, qkv_sites) -> dict:
    """One turn, in the checkout's own process (its source is run there)."""
    import torch

    from animate_anything_tpu_torch.ops import cuda_lib

    cuda_lib.build()
    cuda_lib.library()

    def events_ms(fn, warmup=3, iters=10):
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def spin_device_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        cycles = 1 << 23
        for _ in range(6):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            queued_ahead = not start.query()
            torch.cuda.synchronize()
            if queued_ahead:
                return start.elapsed_time(end) / iters
            cycles *= 4
        raise AssertionError(f"{iters} calls could not be queued ahead of the card")

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(*shape, generator=gen, device="cuda")

    out = {"tap": {}, "proj": {}, "gn": {}, "qkv": {}}
    with torch.no_grad():
        if tap_sites:
            from animate_anything_tpu_torch.ops import temporal_conv as tc
        for bsz, f, s, c in tap_sites:
            x, res = randn(bsz, f, s, c).to(bf), randn(bsz, f, s, c).to(bf)
            a, b = randn(bsz, c, scale=0.1, shift=1.0), randn(bsz, c, scale=0.1)
            w = (randn(c, 3, c) / (3 * c) ** 0.5).to(bf)
            bias = randn(c, scale=0.1)
            run = lambda: tc.tap_conv(x, a, b, w, bias, res)  # noqa: E731
            out["tap"][f"{bsz} {f} {s} {c}"] = dict(ms=events_ms(run),
                                                     device_ms=spin_device_ms(run))
            del x, res
            torch.cuda.empty_cache()
        if proj_sites:
            from animate_anything_tpu_torch.ops import proj_residual as pr
        for n, s, k, c in proj_sites:
            h, r = randn(n, s, k).to(bf), randn(n, s, c).to(bf)
            w, bias = (randn(c, k) / k ** 0.5).to(bf), randn(c, scale=0.1)
            run = lambda: pr.proj_residual_stats(h, w, bias, r)  # noqa: E731
            out["proj"][f"{n} {s} {k} {c}"] = dict(ms=events_ms(run),
                                                    device_ms=spin_device_ms(run))
            del h, r
            torch.cuda.empty_cache()
        if gn_sites or qkv_sites:
            from animate_anything_tpu_torch.ops import ln_qkv_attention as lq
            from animate_anything_tpu_torch.ops import streaming_group_norm as sg
            from animate_anything_tpu_torch.utils.profiling import device_profile
        for n, s, c, silu in gn_sites:
            x = randn(n, s, c).to(bf)
            scale, bias = randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1)
            run = lambda: sg.group_norm_stream(x, scale, bias, 32, 1e-6, silu)  # noqa: E731
            prof = device_profile(lambda: [run() for _ in range(5)])
            out["gn"][f"{n} {s} {c} {silu}"] = dict(ms=events_ms(run),
                                                     device_ms=prof["kernel_ms"] / 5)
            del x
            torch.cuda.empty_cache()
        for b, s, c, h in qkv_sites:
            x = randn(b, s, c).to(bf)
            lns, lnb = randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1)
            ws = [(randn(c, 64 * h) / c ** 0.5).to(bf) for _ in range(3)]
            run = lambda: lq.ln_qkv_attention(x, lns, lnb, *ws, heads=h, head_dim=64,  # noqa: E731
                                              impl="pallas")
            prof = device_profile(lambda: [run() for _ in range(5)])
            groups = prof["groups"]
            out["qkv"][f"{b} {s} {c} {h}"] = dict(
                ms=events_ms(run), device_ms=prof["kernel_ms"] / 5,
                k11_device_ms=groups.get("ln_qkv (kernel 11)", 0.0) / 5,
                k1_device_ms=groups.get("flash_attention (kernel 1)", 0.0) / 5)
            del x
            torch.cuda.empty_cache()
    return out


def _turn(tree: Path, sites: tuple) -> dict:
    src = (inspect.getsource(measure) + "\nimport json\n"
           f"print(json.dumps(measure(*{sites!r})))\n")
    res = subprocess.run([sys.executable, "-c", src], cwd=tree, capture_output=True, text=True,
                         check=False)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: turn failed ({res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--kernels", default="3,4,7,11",
                    help="comma-separated kernel numbers to time (3, 4, 7, 11)")
    args = ap.parse_args(argv)
    kernels = {int(k) for k in args.kernels.split(",")}
    if not kernels <= {3, 4, 7, 11}:
        raise SystemExit(f"--kernels: unknown kernels {sorted(kernels - {3, 4, 7, 11})}")
    from animate_anything_tpu_torch.utils import kernel_sites as ks

    tap_sites = tuple((2, 17, s, c) for s, c in ks.TAP_CONV_SITES) if 3 in kernels else ()
    proj_sites = tuple((34, s, k, c) for s, k, c, _ in ks.PROJ_SITES) if 4 in kernels else ()
    # (n, s, c, SiLU) of each kernel-7 site, once
    gn_sites = (tuple(dict.fromkeys(site[:4] for site in
                                    ks.STREAM_GN_DECODE_SITES + ks.STREAM_GN_ENCODE_SITES))
                if 7 in kernels else ())
    qkv_sites = ks.LN_QKV_SITES if 11 in kernels else ()
    sites = (tap_sites, proj_sites, gn_sites, qkv_sites)
    other = args.other.resolve()
    turns = [("other", other), ("this", HERE), ("this", HERE), ("other", other)]
    results = [(name, _turn(tree, sites)) for name, tree in turns]
    for kind in ("tap", "proj", "gn", "qkv"):
        for site in results[0][1][kind]:
            cells = "  ".join(f"{name} {r[kind][site]['ms']:.4f}/{r[kind][site]['device_ms']:.4f}"
                              for name, r in results)
            print(f"{kind} {site}: events/device ms  {cells}")
    print(json.dumps({"turns": [name for name, _ in results],
                      "results": [r for _, r in results]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
