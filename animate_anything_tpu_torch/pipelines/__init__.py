from animate_anything_tpu_torch.pipelines.latent2video import LatentToVideoPipeline

__all__ = ["LatentToVideoPipeline"]
