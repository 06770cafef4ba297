"""The ZeRO path at one rank is the one-device step, bit for bit: in a
one-rank gloo group (spawned once for the module, so no group outlives it
in the test process), two steps of the tiny UNet with AdamW, the 8-bit
AdamW and LoRA through ``make_train_step(..., mesh=)`` against the same steps
without a mesh: equal metrics, masters and optimizer state, and no
collective issued (the CPU form of ``chip_smoke.run_zero_train_steps``)."""

import pytest
import torch

from test_torch_port_data_parallel import _copy, _run, one_thread

KINDS = ("full", "8bit", "lora", "accum")


def _worker(out: str) -> None:
    import torch.distributed as dist

    from animate_anything_tpu_torch.core.mesh import COLLECTIVES, create_mesh

    mesh = create_mesh({"data": -1})
    results = {}
    COLLECTIVES.on = True
    for kind in KINDS:
        state, snap = _run(kind, mesh)
        assert state.optimizer.plan is not None and state.optimizer.plan.ranks == 1
        results[kind] = snap
    results["collective_ms"] = COLLECTIVES.ms()
    COLLECTIVES(dist.all_reduce, torch.ones(1 << 16))
    results["direct_ms"] = COLLECTIVES.ms()
    COLLECTIVES.on = False
    torch.save(results, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from animate_anything_tpu_torch.dryrun import spawn_ranks

    out = str(tmp_path_factory.mktemp("zero1") / "results.pt")
    spawn_ranks("test_torch_port_zero_one_rank:_worker", 1, "cpu", out, timeout=300,
                group_timeout=120)
    return torch.load(out, weights_only=False)


def _equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got.reshape(want.shape), want), what
    else:
        assert got == want, what


@pytest.mark.parametrize("kind", KINDS)
def test_zero_at_one_rank_is_the_one_device_step(runs, kind):
    with one_thread():              # the spawned rank's thread count, for the same sums
        _, want = _run(kind, None)
    _equal(runs[kind], _copy(want), kind)


def test_the_collectives_are_timed_when_asked(runs):
    """The timer times a collective issued through it; at one rank the steps
    issue none (the plan's collectives return at once)."""
    from animate_anything_tpu_torch.core.mesh import COLLECTIVES

    assert runs["direct_ms"] > 0
    assert runs["collective_ms"] == 0
    assert not COLLECTIVES.on and COLLECTIVES.events == []
