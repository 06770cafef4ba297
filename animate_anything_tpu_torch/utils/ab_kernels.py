"""Kernels 7 and 11 of this checkout beside another checkout's (an earlier
commit, unpacked with ``git archive``) on one card, in turns: the other,
this, this, the other.

    python -m animate_anything_tpu_torch.utils.ab_kernels OTHER_DIR

Each turn is a process of its own that imports the package of its checkout
(its working directory) and builds that checkout's kernels there. It times
``group_norm_stream`` at the VAE's GroupNorm sites (a 512 px image encode
and a 16-frame decode) and ``ln_qkv_attention`` at the UNet's three spatial
self-attention sites, through the public entry points both checkouts have,
on the same seeded inputs: CUDA events around ten calls after three warm-up
calls, and the profiler's device time of a call (all its kernels, and for
``ln_qkv_attention`` kernel 11's and kernel 1's groups). The sites are this
checkout's (``utils/kernel_sites.py``), passed to both turns. Prints one line
a site and, last, one JSON object with every turn's numbers. Needs a card.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def measure(gn_sites, qkv_sites) -> dict:
    """One turn, in the checkout's own process (its source is run there)."""
    import torch

    from animate_anything_tpu_torch.ops import cuda_lib
    from animate_anything_tpu_torch.ops import ln_qkv_attention as lq
    from animate_anything_tpu_torch.ops import streaming_group_norm as sg
    from animate_anything_tpu_torch.utils.profiling import device_profile

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

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"gn": {}, "qkv": {}}
    with torch.no_grad():
        for n, s, c, silu in gn_sites:
            x = torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
            scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
            bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
            run = lambda: sg.group_norm_stream(x, scale, bias, 32, 1e-6, silu)  # noqa: E731
            prof = device_profile(lambda: [run() for _ in range(5)])
            out["gn"][f"{n} {s} {c} {silu}"] = dict(ms=events_ms(run),
                                                     device_ms=prof["kernel_ms"] / 5)
            del x
            torch.cuda.empty_cache()
        for b, s, c, h in qkv_sites:
            x = torch.randn(b, s, c, generator=gen, device="cuda").to(torch.bfloat16)
            lns = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
            lnb = 0.1 * torch.randn(c, generator=gen, device="cuda")
            ws = [(torch.randn(c, 64 * h, generator=gen, device="cuda") / c ** 0.5)
                  .to(torch.bfloat16) for _ in range(3)]
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


def _turn(tree: Path, gn_sites, qkv_sites) -> dict:
    src = (inspect.getsource(measure) + "\nimport json\n"
           f"print(json.dumps(measure({gn_sites!r}, {qkv_sites!r})))\n")
    res = subprocess.run([sys.executable, "-c", src], cwd=tree, capture_output=True, text=True,
                         check=False)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: turn failed ({res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    from animate_anything_tpu_torch.utils.kernel_sites import (LN_QKV_SITES,
                                                               STREAM_GN_DECODE_SITES,
                                                               STREAM_GN_ENCODE_SITES)

    # (n, s, c, SiLU) of each kernel-7 site, once
    gn_sites = tuple(dict.fromkeys(site[:4] for site in
                                   STREAM_GN_DECODE_SITES + STREAM_GN_ENCODE_SITES))
    other = Path(argv[0]).resolve()
    turns = [("other", other), ("this", HERE), ("this", HERE), ("other", other)]
    results = [(name, _turn(tree, gn_sites, LN_QKV_SITES)) for name, tree in turns]
    for kind in ("gn", "qkv"):
        for site in results[0][1][kind]:
            cells = "  ".join(f"{name} {r[kind][site]['ms']:.4f}/{r[kind][site]['device_ms']:.4f}"
                              for name, r in results)
            print(f"{kind} {site}: events/device ms  {cells}")
    print(json.dumps({"turns": [name for name, _ in results],
                      "results": [r for _, r in results]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
