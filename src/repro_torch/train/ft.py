"""Fault tolerance (port of ``repro.train.ft``): checkpoint and restart,
the straggler watchdog and the production loop.

A dead process restarts from the last committed checkpoint (saves every
N steps, committed on a thread; the data stream is a pure function of its
step counter, so a resume is bit-exact); a slow step is flagged by the
watchdog's per-step EWMA.  The checkpoint holds whole leaves whatever
mesh saved it, so ``elastic_restore`` re-shards it onto another mesh as
a plain restore.  On a mesh every rank runs ``run`` (steps and
checkpoints are collective) and rank 0 logs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.train.trainer import Trainer, TrainState


def restore_or_init(trainer: Trainer, ckpt: Checkpointer
                    ) -> Tuple[TrainState, int, Dict]:
    """Resume from the newest committed step, else a fresh init, on the
    trainer's device or mesh.  Returns (state, data_step, extra)."""
    step = ckpt.latest_step()
    if step is None:
        return trainer.init_state(), 0, {}
    return _restore(ckpt, trainer, step)


def _restore(ckpt: Checkpointer, trainer: Trainer, step: int
             ) -> Tuple[TrainState, int, Dict]:
    state, extra = ckpt.restore(step, trainer.init_state(),
                                layout=trainer.layout)
    return state, int(extra.get("data_step", step)), extra


def elastic_restore(ckpt: Checkpointer, trainer_new: Trainer
                    ) -> Tuple[TrainState, int, Dict]:
    """Restore the newest committed step onto ``trainer_new``'s mesh (or
    device), whatever mesh saved it: the same state tree, this rank's
    blocks."""
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError("no committed checkpoint to rescale from")
    return _restore(ckpt, trainer_new, step)


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor: a step over flag_factor x EWMA is a
    straggler event."""
    flag_factor: float = 2.0
    ewma_alpha: float = 0.1
    warmup_steps: int = 3
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def __post_init__(self):
        self.ewma: Optional[float] = None
        self.count = 0
        self.flags = 0
        self.history: list = []

    def observe(self, step: int, dt: float) -> bool:
        self.count += 1
        self.history.append(dt)
        if self.ewma is None:
            self.ewma = dt
            return False
        flagged = (self.count > self.warmup_steps and
                   dt > self.flag_factor * self.ewma)
        if flagged:
            self.flags += 1
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        else:
            # stragglers do not poison the baseline
            self.ewma = (1 - self.ewma_alpha) * self.ewma + \
                self.ewma_alpha * dt
        return flagged


def run(trainer: Trainer, stream, ckpt: Checkpointer, *, steps: int,
        ckpt_every: int = 50, log_every: int = 10,
        watchdog: Optional[StragglerWatchdog] = None,
        log_fn: Callable[[str], None] = print,
        on_step: Optional[Callable[[int, Dict[str, Any], float], None]]
        = None) -> TrainState:
    """The production loop: restore -> step -> watchdog -> checkpoint.
    A step's time includes waiting for the device (where the JAX package
    blocks on the loss); ``on_step(step, metrics, seconds)`` sees every
    step.  On a mesh every rank calls it, and only rank 0 logs."""
    state, data_step, _ = restore_or_init(trainer, ckpt)
    stream.step = data_step
    wd = watchdog or StragglerWatchdog()
    start = int(state.opt.step)
    for step in range(start, steps):
        # data is a pure function of the step index -> bit-exact resume
        batch = stream.batch_at(stream.step)
        stream.step += 1
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        trainer.synchronize()
        dt = time.perf_counter() - t0
        wd.observe(step, dt)
        if on_step is not None:
            on_step(step, metrics, dt)
        if trainer.rank == 0 and (step % log_every == 0 or
                                  step == steps - 1):
            log_fn(f"step {step} loss {float(metrics['loss']):.4f} "
                   f"gnorm {float(metrics['grad_norm']):.3f} "
                   f"dt {dt * 1e3:.1f}ms flags {wd.flags}")
        if ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state, extra={"data_step": stream.step},
                      layout=trainer.layout)
    ckpt.save(steps, state, blocking=True, extra={"data_step": stream.step},
              layout=trainer.layout)
    return state
