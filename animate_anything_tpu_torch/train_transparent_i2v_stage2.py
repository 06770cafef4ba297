"""The transparent RGBA stage-2 entry point — the port of the root
``train_transparent_i2v_stage2.py``:

    python -m animate_anything_tpu_torch.train_transparent_i2v_stage2 \
        --config configs/layerdiffuse_stage2_384.yaml --eval [key.subkey=value ...] [--device cpu]

It forwards to ``cli_stage2.cli`` (sampling; the stage's training is not
published, in the reference either).
"""

from __future__ import annotations

from animate_anything_tpu_torch.cli_stage2 import cli

if __name__ == "__main__":
    cli()
