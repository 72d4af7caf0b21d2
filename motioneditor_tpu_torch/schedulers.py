"""DDIM scheduler math: the step and the inversion step (port of
motioneditor_tpu/schedulers.py).

SD-1.5 schedule: scaled-linear betas, 1000 train steps, steps_offset=1,
set_alpha_to_one=False, epsilon prediction. Tables are computed in float64
with numpy and used as float32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    prediction_type: str = "epsilon"

    @property
    def betas(self) -> np.ndarray:
        if self.beta_schedule == "scaled_linear":
            return np.linspace(self.beta_start**0.5, self.beta_end**0.5,
                               self.num_train_timesteps, dtype=np.float64) ** 2
        if self.beta_schedule == "linear":
            return np.linspace(self.beta_start, self.beta_end, self.num_train_timesteps,
                               dtype=np.float64)
        raise ValueError(f"unknown beta schedule {self.beta_schedule}")

    @property
    def alphas_cumprod(self) -> torch.Tensor:
        return torch.as_tensor(np.cumprod(1.0 - self.betas), dtype=torch.float32)

    @property
    def final_alpha_cumprod(self) -> torch.Tensor:
        if self.set_alpha_to_one:
            return torch.tensor(1.0)
        return self.alphas_cumprod[0]

    def inference_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending timesteps; 50 steps give [981, 961, ..., 21, 1]."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
        ts += self.steps_offset
        return ts.astype(np.int64)


def ddim_step(schedule: DiffusionSchedule, model_output: torch.Tensor, timestep: int,
              sample: torch.Tensor, num_inference_steps: int) -> torch.Tensor:
    """One deterministic DDIM step x_t -> x_{t - ratio} (eta = 0), in fp32,
    returned in the sample's dtype."""
    acp = schedule.alphas_cumprod
    timestep = int(timestep)
    prev_t = timestep - schedule.num_train_timesteps // num_inference_steps
    alpha_t = acp[timestep]
    alpha_prev = acp[prev_t] if prev_t >= 0 else schedule.final_alpha_cumprod
    beta_t = 1.0 - alpha_t
    sample32 = sample.float()
    eps32 = model_output.float()
    pred_x0 = (sample32 - beta_t.sqrt().item() * eps32) / alpha_t.sqrt().item()
    direction = (1.0 - alpha_prev).sqrt().item() * eps32
    return (alpha_prev.sqrt().item() * pred_x0 + direction).to(sample.dtype)


def ddim_inverse_step(schedule: DiffusionSchedule, model_output: torch.Tensor, timestep: int,
                      sample: torch.Tensor, num_inference_steps: int) -> torch.Tensor:
    """One DDIM inversion step x_{t - ratio} -> x_t, given the model output
    at ``sample`` with conditioning timestep ``timestep``. The "from"
    timestep is clamped at 999 and takes final_alpha_cumprod below 0. In
    fp32, returned in the sample's dtype."""
    acp = schedule.alphas_cumprod
    timestep = int(timestep)
    from_t = min(timestep - schedule.num_train_timesteps // num_inference_steps,
                 schedule.num_train_timesteps - 1)
    alpha_from = acp[from_t] if from_t >= 0 else schedule.final_alpha_cumprod
    alpha_to = acp[timestep]
    beta_from = 1.0 - alpha_from
    sample32 = sample.float()
    eps32 = model_output.float()
    x0 = (sample32 - beta_from.sqrt().item() * eps32) / alpha_from.sqrt().item()
    direction = (1.0 - alpha_to).sqrt().item() * eps32
    return (alpha_to.sqrt().item() * x0 + direction).to(sample.dtype)
