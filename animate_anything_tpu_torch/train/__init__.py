from animate_anything_tpu_torch.train.trainer import (AdamW, TrainConfig, TrainState,
                                                      create_lora_train_state,
                                                      create_train_state, make_loss_fn,
                                                      make_lora_train_step, make_optimizer,
                                                      make_train_step, mask_motion_finetune,
                                                      prepare_mask_for_latents,
                                                      trainable_label_tree)

__all__ = [
    "AdamW", "TrainConfig", "TrainState", "create_lora_train_state", "create_train_state",
    "make_loss_fn", "make_lora_train_step", "make_optimizer", "make_train_step",
    "mask_motion_finetune", "prepare_mask_for_latents", "trainable_label_tree",
]
