from animate_anything_tpu_torch.diffusion.samplers import (dpmpp_init, dpmpp_step,
                                                           dpmpp_timesteps, sample_loop)
from animate_anything_tpu_torch.diffusion.schedule import (DiffusionSchedule, add_noise,
                                                           ddpm_forward_mask,
                                                           ddpm_forward_timesteps,
                                                           make_schedule, pred_x0,
                                                           rescale_zero_terminal_snr)

__all__ = [
    "DiffusionSchedule", "add_noise", "ddpm_forward_mask", "ddpm_forward_timesteps",
    "dpmpp_init", "dpmpp_step", "dpmpp_timesteps", "make_schedule", "pred_x0",
    "rescale_zero_terminal_snr", "sample_loop",
]
