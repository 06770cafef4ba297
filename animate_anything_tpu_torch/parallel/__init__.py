from animate_anything_tpu_torch.parallel.partition import ZeroPlan, zero_plan

__all__ = ["ZeroPlan", "zero_plan"]
