"""The port's spans (``utils/tracing.py``) on the CPU: ``torch.profiler``
ranges named ``aat.*`` that nest by time, one tree for a request of each
pipeline and for a train step, and nothing at all while no profile records.
Tiny modules (the ``tiny`` configs), 2 sampler steps, one step of training.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from animate_anything_tpu_torch.utils import tracing
from test_torch_port_helpers import one_thread  # noqa: F401

RES, FRAMES, STEPS = 32, 2, 2


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def ranges(prof) -> list:
    """(name, start, end, args) of every ``aat.*`` range, in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.concrete_inputs())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name().startswith(tracing.PREFIX)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def inside(rs: list, outer: tuple, name: str) -> list:
    return [r for r in rs if r[0] == name and outer[1] <= r[1] and r[2] <= outer[2]
            and r is not outer]


def names(rs: list) -> set:
    return {r[0] for r in rs}


def _text():
    from animate_anything_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from animate_anything_tpu_torch.models.tokenizers import HashTokenizer
    from animate_anything_tpu_torch.utils.convert import init_clip_text_

    cfg = CLIPTextConfig.tiny(max_position_embeddings=77)
    return (init_clip_text_(CLIPTextModel(cfg), _gen(1)).eval(),
            HashTokenizer(cfg.vocab_size, 77))


def _vae():
    from animate_anything_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from animate_anything_tpu_torch.utils.convert import init_vae_

    return init_vae_(AutoencoderKL(VAEConfig.tiny()), _gen(2)).eval()


def _unet3d():
    from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from animate_anything_tpu_torch.utils.convert import init_unet3d_

    cfg = UNet3DConfig.tiny(motion_mask=True, motion_strength=True, attn_impl="pallas")
    return init_unet3d_(UNet3DConditionModel(cfg), _gen(0))


def _mask_motion_request():
    from animate_anything_tpu_torch.pipelines import LatentToVideoPipeline

    text, tok = _text()
    pipe = LatentToVideoPipeline(_unet3d().eval(), _vae(), text_encoder=text, tokenizer=tok)
    r = np.random.default_rng(0)
    image = r.integers(0, 256, (RES, RES, 3), dtype=np.uint8)
    mask = np.where(r.random((RES, RES)) > 0.5, 255, 0).astype(np.uint8)
    return lambda: pipe.animate_image(image, "a ball rolls", mask_img=mask, motion_strength=3.0,
                                      num_frames=FRAMES, num_inference_steps=STEPS,
                                      generator=_gen(3))


def _svd_request():
    from animate_anything_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                            UNetSpatioTemporalConditionModel)
    from animate_anything_tpu_torch.pipelines.svd import MaskStableVideoDiffusionPipeline
    from animate_anything_tpu_torch.utils.convert import init_svd_unet_

    cfg = SVDUNetConfig.tiny(in_channels=9, attn_impl="pallas", block_out_channels=(32, 64),
                             num_attention_heads=(2, 4), layers_per_block=1)
    unet = init_svd_unet_(UNetSpatioTemporalConditionModel(cfg), _gen(0)).eval()
    pipe = MaskStableVideoDiffusionPipeline(unet, _vae())
    image = np.random.default_rng(0).integers(0, 256, (RES, RES, 3), dtype=np.uint8)
    mask = torch.ones(1, 1, RES // 8, RES // 8, 1)
    emb = torch.randn(1, 1, 32, generator=_gen(4))
    return lambda: pipe(image, image_embeddings=emb, mask=mask, num_frames=FRAMES,
                        num_inference_steps=STEPS, generator=_gen(3))


REQUESTS = {"mask_motion": _mask_motion_request, "svd": _svd_request}


def test_spans_are_one_shared_no_op_while_nothing_records():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("unet") is tracing.OFF
    calls = []

    @tracing.traced("op.x")
    def op(v):
        calls.append(v)
        return v + 1

    @tracing.traced_request
    def request():
        return tracing.sync(float, torch.ones(()))

    first = tracing.request_id()
    assert op(1) == 2 and calls == [1] and op.__name__ == "op"
    assert request() == 1.0
    assert tracing.request_id() == first + 1       # an untraced request takes no id
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.span("unet") is not tracing.OFF
        with tracing.span("unet"):
            op(2)
    assert [r[0] for r in ranges(prof)] == ["aat.unet", "aat.op.x"]


@pytest.mark.parametrize("pipeline", sorted(REQUESTS))
def test_a_request_is_one_tree_of_spans(pipeline):
    run = REQUESTS[pipeline]()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    rs = ranges(prof)
    (req,) = [r for r in rs if r[0] == "aat.request"]
    (denoise,) = inside(rs, req, "aat.denoise")
    (decode,) = inside(rs, req, "aat.decode")
    encodes = inside(rs, req, "aat.encode")
    assert encodes and all(e[2] <= denoise[1] for e in encodes)
    assert denoise[2] <= decode[1]
    steps = inside(rs, denoise, "aat.step")
    assert len(steps) == STEPS
    for step in steps:
        (unet,) = inside(rs, step, "aat.unet")
        ops = [r for r in rs if r[0].startswith("aat.op.") and unet[1] <= r[1]
               and r[2] <= unet[2]]
        assert {"aat.op.ln_geglu_ff", "aat.op.gn_silu_tap_conv"} <= names(ops)
    assert len([r for r in rs if r[0] == "aat.unet"]) == STEPS    # one CFG call a step
    assert "aat.sync" not in names(rs)


def test_the_request_span_carries_its_id():
    from animate_anything_tpu_torch.serving import VideoServer

    @tracing.traced_request
    def request():
        return torch.ones(2).sum()

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        request()
        request()
        with tracing.serving(0xABC123):
            request()
    ids = [r[3][0] for r in ranges(prof)]
    assert ids[1] == ids[0] + 1 and ids[2] == 0xABC123

    # the server's worker runs each job inside its job id
    seen = []
    server = VideoServer(lambda req: seen.append(tracing.request_id()) or "out.gif")
    job = server.submit({})
    server.shutdown()                  # after the job, in the queue's order
    server._worker.join(timeout=60)
    assert not server._worker.is_alive()
    assert job.status == "done" and seen == [int(job.id, 16)]


def _train_step(lora: bool):
    from animate_anything_tpu_torch.diffusion import make_schedule
    from animate_anything_tpu_torch.train.trainer import (TrainConfig, create_lora_train_state,
                                                          create_train_state,
                                                          make_lora_train_step, make_train_step)

    text, tok = _text()
    vae = _vae()
    unet = _unet3d().train()
    conf = TrainConfig(motion_mask=True, motion_strength=True, text_dropout=0.0,
                       max_grad_norm=1e-6)     # clips: the clip factor's read runs
    schedule = make_schedule(prediction_type="v_prediction")
    if lora:
        from animate_anything_tpu_torch.models.lora import (LoraConfig, init_lora_params,
                                                            lora_params)

        lcfg = LoraConfig(rank=2)
        params = lora_params(unet)
        tree = {"unet_lora": init_lora_params(_gen(5), params, lcfg)}
        base = {p: params[p].detach().clone() for p in tree["unet_lora"]}
        unet.requires_grad_(False)
        state = create_lora_train_state(tree, conf)
        step = make_lora_train_step(schedule, conf, unet, base, lcfg, text_encoder=text,
                                    vae=vae, device="cpu")
    else:
        state = create_train_state(unet, conf)
        step = make_train_step(schedule, conf, vae=vae, text_encoder=text, device="cpu")
    ids = torch.as_tensor(tok(["a ball", ""], padding="max_length", max_length=77,
                              return_tensors="np").input_ids)
    batch = {"pixel_values": torch.rand(1, FRAMES, RES, RES, 3, generator=_gen(6)) * 2 - 1,
             "mask": torch.full((1, RES, RES), 255.0), "prompt_ids": ids[:1],
             "uncond_ids": ids[1:]}
    return lambda: step(state, batch, _gen(7))


@pytest.mark.parametrize("lora", [False, True], ids=["finetune", "lora"])
def test_a_train_step_is_one_tree_of_phases(lora):
    """inputs, loss, backward, metrics, optimizer in turn; the optimizer
    holds its own norm, the update (holding the clip's norm) and, for the
    finetune, the masters' copy; one sync for each metric, the dropout flag,
    the clip factor and the returned norm."""
    run = _train_step(lora)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    rs = ranges(prof)
    (step,) = [r for r in rs if r[0] == "aat.train_step"]
    phases = [r for r in rs if r[0] in ("aat.inputs", "aat.loss", "aat.backward",
                                        "aat.metrics", "aat.optimizer")]
    assert [r[0] for r in phases] == ["aat.inputs", "aat.loss", "aat.backward", "aat.metrics",
                                      "aat.optimizer"]
    assert all(step[1] <= r[1] and r[2] <= step[2] for r in phases)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    inputs, loss, _, metrics, opt = phases
    assert len(inside(rs, inputs, "aat.encode")) == 1
    assert len(inside(rs, loss, "aat.unet")) == 1
    (update,) = inside(rs, opt, "aat.update")
    assert len(inside(rs, opt, "aat.norm")) == 2 and len(inside(rs, update, "aat.norm")) == 1
    assert len(inside(rs, opt, "aat.masters")) == (0 if lora else 1)
    syncs = inside(rs, step, "aat.sync")
    assert len(inside(rs, metrics, "aat.sync")) == 3 == len(out) - 1   # loss, mse, motion
    assert len(inside(rs, loss, "aat.sync")) == 1                       # the dropout flag
    assert len(inside(rs, update, "aat.sync")) == 1                     # the clip factor
    assert len(syncs) == 6
