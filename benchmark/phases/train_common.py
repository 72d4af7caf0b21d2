"""What the training phases after ``stage1.py`` share: ``stage1.Phase``'s
loop, readings and check, with the model, the inputs, the program's step
and the reference's loss as a subclass's own (``stage1_sdxl.py``,
``stage2.py``). Not a phase of a traffic mix itself.

A subclass sets ``modules`` (the reference's trainables) and defines:

  build_model()                    the program's model to train, filled from the seed
  make_state(model, optimizer)     the program's train state
  inputs(device)                   the clip's inputs, from the seed
  program_step(generator)          one step of the program; its loss
  reference_model(precision)       the reference's twin of the model
  reference_loss(ref, noise, t)    the reference's loss of a step
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from benchmark.phases import stage1
from benchmark.phases.common import SALT_STEPS, PhaseBase


class TrainPhase(stage1.Phase):
    kind = "train"
    modules = ()

    def __init__(self, ctx):
        from motioneditor_tpu_torch.schedulers import DiffusionSchedule
        from motioneditor_tpu_torch.training.common import make_optimizer

        PhaseBase.__init__(self, ctx)
        t, opt = self.traffic, ctx.cell.config["optimizer"]
        self.forward_passes = 2 if ctx.cell.config["gradient_checkpointing"] else 1
        self.schedule = DiffusionSchedule(**{k: self.sched[k] for k in (
            "num_train_timesteps", "beta_start", "beta_end", "steps_offset")})
        self.state = self.make_state(self.build_model(), make_optimizer(
            opt["lr"], opt["beta1"], opt["beta2"], opt["eps"], opt["weight_decay"],
            opt["max_grad_norm"]))
        self.x = self.inputs(ctx.device)
        self.step = 0
        start = {n: p.detach().clone() for n, p in self.state.trainable.items()}
        self.losses, self.grad_norms = [], {}
        for k in range(t["check"]["steps"]):
            self.losses.append(float(self._train_step()))
            if k == 0:
                inner = self.state.optimizer.inner
                self.grad_norms = {n: (inner.state[p]["exp_avg"] / (1 - opt["beta1"])).norm().item()
                                   for n, p in self.state.trainable.items()}
        self.change_norms = {n: (p.detach() - start[n]).norm().item()
                             for n, p in self.state.trainable.items()}
        del start
        self.window_at = self._window_sample()
        self.kept = []  # per checked window step: the state before it and its readings
        self.pending = None  # the loss of the step dispatched last, not yet read
        self.read_at = []  # the host's clock as each window step's loss was read

    def _train_step(self) -> torch.Tensor:
        with record_function("bench.train_step"):
            loss = self.program_step(self.gen(SALT_STEPS, self.step))
        self.step += 1
        return loss

    def _replay(self, precision: str, steps: int, start=None):
        """AdamW steps of the reference, as ``stage1.Phase._replay``: from the
        seed's weights (``start`` None) or from a window step's kept state."""
        opt = self.ctx.cell.config["optimizer"]
        ref = self.reference_model(precision)
        names = [n for n in ref.p if stage1.trainable(n, self.modules)]
        if start is None:
            w = [ref.p[n] for n in names]
            m = [torch.zeros_like(p) for p in w]
            v = [torch.zeros_like(p) for p in w]
            t0, k0 = 0, 0
        else:
            w, m, v = ([start[key][n].float().clone() for n in names] for key in "wmv")
            t0, k0 = start["t"], start["index"]
        w0 = [p.clone() for p in w]
        lat = self.x["latents"]
        losses, grad_norms = [], {}
        for k in range(steps):
            leaves = [(p if start is None else p.to(self.dtype).float()).detach()
                      .requires_grad_(True) for p in w]
            ref.p.update(zip(names, leaves))
            g = self.gen(SALT_STEPS, k0 + k)  # the program's draw: noise, then the timesteps
            noise = torch.randn(lat.shape, generator=g, device=lat.device, dtype=lat.dtype)
            t = torch.randint(0, self.sched["num_train_timesteps"], (lat.shape[0],),
                              generator=g, device=lat.device)
            loss = self.reference_loss(ref, noise, t)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(leaves, grads)]
            losses.append(loss.item())
            with torch.no_grad():
                norm = torch.sqrt(sum((gr ** 2).sum() for gr in grads))
                if norm >= opt["max_grad_norm"]:
                    grads = [gr / norm * opt["max_grad_norm"] for gr in grads]
                if k == 0:
                    grad_norms = {n: gr.norm().item() for n, gr in zip(names, grads)}
                bc1 = 1 - opt["beta1"] ** (t0 + k + 1)
                bc2 = 1 - opt["beta2"] ** (t0 + k + 1)
                for p, gr, mk, vk in zip(w, grads, m, v):
                    p.mul_(1 - opt["lr"] * opt["weight_decay"])
                    mk.mul_(opt["beta1"]).add_(gr, alpha=1 - opt["beta1"])
                    vk.mul_(opt["beta2"]).addcmul_(gr, gr, value=1 - opt["beta2"])
                    p.sub_(opt["lr"] / bc1 * mk / (vk.sqrt() / bc2 ** 0.5 + opt["eps"]))
        changes = {n: (p - s).norm().item() for n, p, s in zip(names, w, w0)}
        return losses, grad_norms, changes
