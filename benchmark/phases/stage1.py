"""Stage-1 training: ``train_step_stage1`` in the loop that ``train_bg.main``
runs, each step's loss read back once the next step is dispatched, so that
the card runs one step while the host dispatches the next, and a stall of
the host is covered by the work queued before it. Batch 1; the step's
noise and timestep come from a generator seeded by (seed, step).

Set-up builds the one train state (bf16 frozen weights, fp32 masters of
the trainables, AdamW with global-norm clipping) and drives it through its
first steps with the window's own call, keeping what the check compares:
the first gradient as the optimizer got it (AdamW's first moment after one
step, over 1 - beta1) and each trainable's change after the first steps;
the window then goes on with the same state. The check runs the same steps in the reference from the
same weights, noise and timesteps.

The window's own steps are checked too: before each of a few steps drawn
from the seed the phase keeps the program's masters, AdamW's moments and
step count, and after it, per trainable, the norms of its gradient as the
optimizer got it ((m' - beta1 m) / (1 - beta1)) and of its change. The reference replays each such step from that state, its
forward on the masters rounded to the configuration's dtype as the
program computes with them: from a window step on it follows the program's
own state.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import data
from benchmark.harness import log
from benchmark.phases.common import (
    SALT_INPUTS,
    SALT_STEPS,
    PhaseBase,
    build,
    meta_reference,
    reference,
    unet_config,
)
from benchmark.reference import sd15_video as R


def trainable(name: str, modules) -> bool:
    """The stage's selection: a parameter trains when its module path ends
    with one of ``modules`` or holds one as a dotted segment."""
    path = name.rsplit(".", 1)[0]
    return any(path.endswith(m) or f".{m}." in f".{path}." for m in modules)


def leaf_gap(got: dict, want: dict, names) -> float:
    """The worst leaf's |‖got‖ - ‖want‖| over the larger of its reference
    norm and the median leaf's."""
    median = torch.tensor([want[n] for n in want]).median().item()
    return max(abs(got[n] - want[n]) / max(want[n], median) for n in names)


class Phase(PhaseBase):
    kind = "train"

    def __init__(self, ctx):
        from motioneditor_tpu_torch.schedulers import DiffusionSchedule
        from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

        super().__init__(ctx)
        t, opt = self.traffic, ctx.cell.config["optimizer"]
        self.modules = ctx.cell.config["trainable_modules"]
        self.forward_passes = 2 if ctx.cell.config["gradient_checkpointing"] else 1
        self.unet_cfg = unet_config(ctx.model)
        self.schedule = DiffusionSchedule(**{k: self.sched[k] for k in (
            "num_train_timesteps", "beta_start", "beta_end", "steps_offset")})
        unet = build(ctx, "unet", self.dtype)
        self.state = make_train_state(
            unet, self.modules,
            make_optimizer(opt["lr"], opt["beta1"], opt["beta2"], opt["eps"],
                           opt["weight_decay"], opt["max_grad_norm"]),
            frozen_dtype=self.dtype)
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

    def _window_sample(self) -> list:
        """The global indices of the window steps to check: one drawn from
        each [lo, hi) of ``window_steps``, counted from the window's first."""
        rng = np.random.default_rng(data.sub_seed(self.ctx.seed, 52))
        first = self.traffic["check"]["steps"]
        return [first + int(rng.integers(lo, hi))
                for lo, hi in self.traffic["check"]["window_steps"]]

    def inputs(self, device) -> dict:
        """The clip's latents (0.18215 x a normal draw, fp32 as the VAE gives
        them) and the prompt's embedding, from the seed."""
        t = self.traffic
        latent = t["resolution"] // 8
        g = self.gen(SALT_INPUTS)
        return {
            "latents": 0.18215 * torch.randn((t["batch"], t["frames"], latent, latent, 4),
                                             generator=g, device=device),
            "text": torch.randn((t["batch"], *self.text), generator=g,
                                device=device),
        }

    def _train_step(self) -> torch.Tensor:
        from motioneditor_tpu_torch.training.stage1 import train_step_stage1

        with record_function("bench.train_step_stage1"):
            self.state, out = train_step_stage1(
                self.state, self.x["latents"], self.x["text"], self.gen(SALT_STEPS, self.step),
                self.unet_cfg, self.schedule, prediction_type="epsilon", use_flash=True,
                remat=self.ctx.cell.config["gradient_checkpointing"], compute_dtype=self.dtype)
        self.step += 1
        return out["loss"]

    def _read_late(self, loss: torch.Tensor, mark: bool = True) -> None:
        """Reads the loss of the step before ``loss``'s, as train_bg.main
        reads every step's, and keeps ``loss`` for the next call."""
        with record_function("bench.loss_readback"):
            if self.pending is not None:
                float(self.pending)
                if mark:
                    self.read_at.append(time.perf_counter())
            self.pending = loss

    def run_chunk(self):
        self._read_late(self._kept_step() if self.step in self.window_at else self._train_step())
        return 1, "train"

    def trace_chunk(self):
        self._read_late(self._train_step(), mark=False)
        return 1, "train"

    def _kept_step(self) -> torch.Tensor:
        """One window step with the state before it kept on the device, and
        its readings as device tensors: nothing waits on the card. Returns
        the step's loss."""
        b1 = self.ctx.cell.config["optimizer"]["beta1"]
        inner = self.state.optimizer.inner
        params = self.state.trainable
        with torch.no_grad():
            before = {
                "index": self.step,
                "w": {n: p.detach().clone() for n, p in params.items()},
                "m": {n: inner.state[p]["exp_avg"].clone() for n, p in params.items()},
                "v": {n: inner.state[p]["exp_avg_sq"].clone() for n, p in params.items()},
                "t": int(inner.state[next(iter(params.values()))]["step"]),
            }
        loss = before["loss"] = self._train_step()
        with torch.no_grad():
            before["grads"] = {n: ((inner.state[p]["exp_avg"] - b1 * before["m"][n]) / (1 - b1))
                               .norm() for n, p in params.items()}
            before["changes"] = {n: (p.detach() - before["w"][n]).norm()
                                 for n, p in params.items()}
        self.kept.append(before)
        return loss

    def free_program(self) -> None:
        gaps = np.diff(self.read_at) * 1e3
        if len(gaps):
            log(f"[stage1] ms between loss reads: median {np.median(gaps)!r}, "
                f"quartiles {np.percentile(gaps, [25, 75]).tolist()!r}, "
                f"max {gaps.max()!r} at read {int(gaps.argmax())}, min {gaps.min()!r}")
        del self.state
        self.pending = None

    # -- the check -----------------------------------------------------------------

    def _replay(self, precision: str, steps: int, start=None):
        """AdamW steps of the reference: from the seed's weights (``start``
        None), or from a window step's kept state, whose forward takes the
        masters rounded to the configuration's dtype as the program's layers
        cast them. (losses, first gradient's and change's norms by leaf)."""
        opt = self.ctx.cell.config["optimizer"]
        ref = reference(self.ctx, "unet", precision)
        names = [n for n in ref.p if trainable(n, self.modules)]
        if start is None:
            w = [ref.p[n] for n in names]
            m = [torch.zeros_like(p) for p in w]
            v = [torch.zeros_like(p) for p in w]
            t0, k0 = 0, 0
        else:
            w, m, v = ([start[key][n].float().clone() for n in names] for key in "wmv")
            t0, k0 = start["t"], start["index"]
        w0 = [p.clone() for p in w]
        lat, text = self.x["latents"], self.x["text"]
        losses, grad_norms = [], {}
        for k in range(steps):
            leaves = [(p if start is None else p.to(self.dtype).float()).detach()
                      .requires_grad_(True) for p in w]
            ref.p.update(zip(names, leaves))
            g = self.gen(SALT_STEPS, k0 + k)  # the program's draw: noise, then the timesteps
            noise = torch.randn(lat.shape, generator=g, device=lat.device, dtype=lat.dtype)
            t = torch.randint(0, self.sched["num_train_timesteps"], (lat.shape[0],),
                              generator=g, device=lat.device)
            loss = R.stage1_loss(ref, self.acp, lat, text, noise, t)
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

    def _numbers(self, losses, grad_norms, changes, want, window=False):
        ref_losses, ref_grads, ref_changes = want
        if set(grad_norms) != set(ref_grads):
            raise ValueError("the program's trainables differ from the reference's: "
                             f"{sorted(set(grad_norms) ^ set(ref_grads))[:6]}")
        median = torch.tensor(list(ref_grads.values())).median().item()
        # leaves whose reference gradient is nought to rounding move under
        # Adam by round-off alone: their change is not compared
        moved = [n for n in ref_grads if ref_grads[n] >= 1e-3 * median]
        # the loss is not compared: a mean over the whole clip averages the
        # rounding away, the float8 control's with it (PERF.md, section 2)
        log(f"[stage1] loss gap (not compared): "
            f"{abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])!r}")
        names = ("grad_w_err", "change_w_err") if window else ("grad_err", "change_err")
        return list(zip(names, (
            leaf_gap(grad_norms, ref_grads, ref_grads),
            leaf_gap(changes, {n: ref_changes[n] for n in moved}, moved))))

    def _window_numbers(self, precision=None):
        """The checked window steps' numbers, the worst step: the program's
        readings, or with ``precision`` the reference at that precision
        replaying the same steps from the same states."""
        if not self.kept:
            raise ValueError(f"the window ended before its first checked step {self.window_at}")
        log(f"[stage1] window steps checked: {[k['index'] for k in self.kept]} "
            f"of {self.window_at}")
        worst = {}
        for kept in self.kept:
            want = self._replay("fp32", 1, kept)
            if precision is None:
                got = ([float(kept["loss"])], {n: x.item() for n, x in kept["grads"].items()},
                       {n: x.item() for n, x in kept["changes"].items()})
            else:
                got = self._replay(precision, 1, kept)
            log(f"[stage1] window step {kept['index']}: loss {got[0][0]}, "
                f"reference {want[0][0]}")
            for name, value in self._numbers(*got, want, window=True):
                worst[name] = max(worst.get(name, 0.0), value)
        return list(worst.items())

    def check(self):
        R.strict_fp32()
        steps = self.traffic["check"]["steps"]
        want = self._replay("fp32", steps)
        log(f"[stage1] losses {self.losses}, reference {want[0]}")
        return (self._numbers(self.losses, self.grad_norms, self.change_norms, want)
                + self._window_numbers())

    def control(self, precision: str = "fp8"):
        """The same numbers with the reference at ``precision`` in the program's place."""
        R.strict_fp32()
        steps = self.traffic["check"]["steps"]
        return (self._numbers(*self._replay(precision, steps), self._replay("fp32", steps))
                + self._window_numbers(precision))

    # -- work ------------------------------------------------------------------------

    def count_step(self, kind: str, sites: list) -> None:
        """The forward and the backward without recompute; weight gradients
        only for the trainables."""
        t = self.traffic
        latent = t["resolution"] // 8
        ref = meta_reference(self.ctx.model, "unet", sites,
                             trainable=lambda n: trainable(n, self.modules))
        lat = torch.empty((t["batch"], t["frames"], latent, latent, 4), device="meta")
        text = torch.empty((t["batch"], *self.text), device="meta")
        tt = torch.zeros((t["batch"],), dtype=torch.long, device="meta")
        acp = self.acp.to("meta")
        R.stage1_loss(ref, acp, lat, text, lat, tt).backward()
