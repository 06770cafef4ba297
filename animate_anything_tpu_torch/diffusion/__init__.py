from animate_anything_tpu_torch.diffusion.samplers import (ddim_step, ddim_timesteps,
                                                           dpmpp_init, dpmpp_step,
                                                           dpmpp_timesteps, sample_loop)
from animate_anything_tpu_torch.diffusion.schedule import (DiffusionSchedule, add_noise,
                                                           ddpm_forward_mask,
                                                           ddpm_forward_timesteps,
                                                           get_velocity, make_schedule,
                                                           pred_epsilon, pred_x0,
                                                           rescale_zero_terminal_snr,
                                                           sample_noise)

__all__ = [
    "DiffusionSchedule", "add_noise", "ddim_step", "ddim_timesteps", "ddpm_forward_mask",
    "ddpm_forward_timesteps",
    "dpmpp_init", "dpmpp_step", "dpmpp_timesteps", "get_velocity", "make_schedule",
    "pred_epsilon", "pred_x0", "rescale_zero_terminal_snr", "sample_loop", "sample_noise",
]
