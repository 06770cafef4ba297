"""A small size of each configuration and its traffic, for the CPU tests:
the same graph, narrow widths, a 64-pixel clip of few frames and steps."""

TINY_A512 = {
    "config": {"unet": {"block_out_channels": [32, 64, 64, 64], "cross_attention_dim": 32,
                        "attention_head_dim": 8, "norm_num_groups": 8},
               "vae": {"block_out_channels": [16, 32, 32, 32], "norm_num_groups": 4},
               "text_encoder": {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
                                "num_attention_heads": 2, "intermediate_size": 64,
                                "max_position_embeddings": 16}},
    "traffic": {"resolution": 64, "frames": 4, "steps": 3},
}

TINY_SVD = {
    "config": {"unet": {"block_out_channels": [32, 64, 64, 64], "num_attention_heads": [2, 4, 4, 4],
                        "cross_attention_dim": 32, "addition_time_embed_dim": 8,
                        "projection_class_embeddings_input_dim": 24},
               "vae": {"block_out_channels": [16, 32, 32, 32], "norm_num_groups": 4},
               "image_encoder": {"hidden_size": 32, "num_hidden_layers": 2,
                                 "num_attention_heads": 2, "intermediate_size": 64,
                                 "image_size": 32, "patch_size": 8, "projection_dim": 32}},
    "traffic": {"resolution": 64, "frames": 4, "steps": 3, "decode_chunk": 2},
}

TINY_TRAIN = {"config": TINY_A512["config"],
              "traffic": {"batch": 2, "resolution": 64, "frames": 4, "drift_px": 2}}

TINY = {"a512.request": TINY_A512, "svd.request": TINY_SVD, "a512.train_b4": TINY_TRAIN}


def tiny_system(cell: str):
    """(System, traffic, workload spec) of ``cell`` at its small size, on the CPU."""
    from perfbench import run
    from perfbench.harness import registry

    spec = registry.workload(cell)
    over = TINY[cell]
    cfg = run._merged(registry.config(spec["config"]), over["config"])
    traffic = run._merged(registry.traffic(spec["traffic"]), over["traffic"])
    return registry.config_module(spec["config"]).System(cfg, "cpu"), traffic, spec


def tiny_run(cell: str, seed: int = 3, patch=None) -> dict:
    """One run of ``cell`` on the CPU at its small size, without the card
    check; ``patch(program)`` breaks the program under the timed path."""
    import time

    from perfbench import run

    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                      "--trace", "0"])
    over = dict(TINY[cell])
    if patch is not None:
        over["program_patch"] = patch
    return run.execute(args, device="cpu", overrides=over, t0=time.perf_counter())
