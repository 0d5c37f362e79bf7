"""Fault-tolerant training loop (the reference's `train/trainer.py`).

  - checkpoint/restart: async checkpoints every `ckpt_every` steps; on
    (re)start the trainer restores the latest step and the deterministic
    data pipeline replays that step's batch (no loader state);
  - failure handling: a failure injector (tests, `chip_smoke.py`) can make
    a step raise `RuntimeError`; the loop restores the last checkpoint and
    goes on; non-finite gradients skip the update inside the step;
  - the host syncs with the device only to log, every `log_every` steps,
    and in the final blocking save.

The trainer runs on CUDA unless the caller asks for the CPU: batches from
`batch_fn` (numpy) are moved to that device, and `init_params_fn` must
return parameters there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainState, init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    warmup: int = 20
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    grad_accum: int = 1  # microbatches a step (the reference's trainer takes 1)


class Trainer:
    def __init__(self, loss_fn: Callable, init_params_fn: Callable[[], object],
                 batch_fn: Callable[[int], dict],  # step -> batch (deterministic!)
                 cfg: TrainerConfig, device: DeviceLike = None):
        self.loss_fn = loss_fn
        self.init_params_fn = init_params_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step_fn = make_train_step(loss_fn, cfg.opt, warmup=cfg.warmup,
                                       total_steps=cfg.total_steps, grad_accum=cfg.grad_accum)
        self.ckpt = Checkpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None
        self.history: List[Dict] = []

    def _init_or_restore(self) -> TrainState:
        state = init_train_state(self.init_params_fn())
        if self.ckpt and latest_step(self.ckpt.directory) is not None:
            state, step = self.ckpt.restore_latest(state)
            print(f"[trainer] restored step {step}")
        return state

    def run(self, failure_injector: Optional[Callable[[int], None]] = None) -> TrainState:
        state = self._init_or_restore()
        start = int(state.step)
        t0 = time.time()
        step = start
        while step < self.cfg.total_steps:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.batch_fn(step).items()}
            try:
                if failure_injector is not None:
                    failure_injector(step)
                state, metrics = self.step_fn(state, batch)
            except RuntimeError as e:  # injected / simulated node failure
                print(f"[trainer] step {step} failed ({e}); restoring")
                if self.ckpt is None:
                    raise RuntimeError("failure without checkpointing configured") from e
                self.ckpt.wait()
                # every leaf of the state is overwritten, whatever the failed
                # step left in it; no second copy of the state is made
                state, _ = self.ckpt.restore_latest(state)
                step = int(state.step)
                continue
            if step % self.cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                self.history.append(m)
                print(f"[trainer] step {step} loss={m.get('loss', float('nan')):.4f} "
                      f"gnorm={m.get('grad_norm', float('nan')):.3f}")
            step += 1
            if self.ckpt and step % self.cfg.ckpt_every == 0:
                self.ckpt.save(step, state)
        if self.ckpt:
            self.ckpt.save(self.cfg.total_steps, state, blocking=True)
        print(f"[trainer] {step - start} steps in {time.time() - t0:.1f}s")
        return state
