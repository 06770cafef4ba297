from animate_anything_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig

__all__ = ["UNet3DConditionModel", "UNet3DConfig"]
