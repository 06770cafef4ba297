"""The LoRA training entry point — the port of the root ``train_lora.py``:

    python -m animate_anything_tpu_torch.train_lora --config configs/train_mask_motion_lora.yaml \
        [key.subkey=value ...] [--device cpu]

``cli.cli`` with ``use_unet_lora=true`` appended unless the arguments set
it: ``train_lora`` implies UNet LoRA unless the config turns it off there.
"""

from __future__ import annotations

import sys

from animate_anything_tpu_torch.cli import cli


def train_lora(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("use_unet_lora=") for a in argv):
        argv.append("use_unet_lora=true")
    cli(argv)


if __name__ == "__main__":
    train_lora()
