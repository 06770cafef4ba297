"""The SVD entry point — the port of the root ``train_svd.py``:

    python -m animate_anything_tpu_torch.train_svd --config configs/train_svd_mask.yaml \
        [--eval] [key.subkey=value ...] [--device cpu]

It forwards to ``cli_svd.cli``: training without ``--eval``, sampling with it.
"""

from __future__ import annotations

from animate_anything_tpu_torch.cli_svd import cli

if __name__ == "__main__":
    cli()
