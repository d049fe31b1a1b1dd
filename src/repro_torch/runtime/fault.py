"""Fault tolerance, the counterpart of ``repro.runtime.fault``.

  - ``Supervisor.run`` wraps a step loop: an exception rolls back to the
    latest checkpoint and resumes, up to ``max_restarts`` times; past that
    the exception propagates.
  - ``SessionSupervisor.run`` drives a ``SessionRuntime`` through an event
    stream with a session checkpoint at event boundaries, so a restart
    replays no completed event.
  - ``StragglerMonitor`` flags a step far slower than the trailing median.
  - ``healthy_mesh_shape`` picks the (data, model) grid that survives on a
    number of devices; ``elastic_remesh`` / ``elastic_session_mesh`` rebuild
    a mesh over the surviving devices. A session's logical shard layout
    travels in its checkpoint, so ``SessionSupervisor``'s ``make_runtime``
    may build its runtime over fewer devices after a failure: restored shard
    ``s`` lands on ``devices[s % len(devices)]`` and the run continues
    bitwise. ``elastic_remesh`` keeps a model axis and shrinks the data
    axis.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    latest_checkpoint,
    restore_runtime_session,
    save_runtime_session,
)
from repro_torch.runtime.sharding import Mesh, make_mesh

Params = Any


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps that run far slower than the trailing median."""

    window: int = 32
    factor: float = 2.0
    _durations: list = dataclasses.field(default_factory=list)

    def record(self, seconds: float) -> bool:
        """True if this step is a straggler against the trailing median."""
        history = self._durations[-self.window:]
        self._durations.append(seconds)
        if len(history) < 8:
            return False
        return seconds > self.factor * float(np.median(history))

    @property
    def median(self) -> float:
        return float(np.median(self._durations[-self.window:])) if self._durations else 0.0


def healthy_mesh_shape(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """Largest (data, model) grid on the surviving devices: the model axis
    stays fixed (the weights must still fit) and the data axis shrinks."""
    data = n_devices // model_parallel
    if data < 1:
        raise RuntimeError(f"cannot keep model_parallel={model_parallel} on {n_devices} devices")
    return (data, model_parallel)


def elastic_remesh(model_parallel: int, devices=None) -> Mesh:
    """The (data, model) mesh over the surviving ``devices`` (default: every
    CUDA device): ``healthy_mesh_shape`` keeps the model axis and shrinks
    the data axis."""
    devices = _devices(devices)
    return make_mesh(healthy_mesh_shape(len(devices), model_parallel), ("data", "model"), devices=devices)


def elastic_session_mesh(devices=None) -> Mesh:
    """The data-only session mesh over the surviving ``devices`` (default:
    every CUDA device): the session's logical shards are a checkpoint
    property and stay; only their devices change."""
    devices = _devices(devices)
    return make_mesh((len(devices),), ("data",), devices=devices)


def _devices(devices) -> list:
    if devices is not None:
        return list(devices)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device survives: pass the surviving devices explicitly")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class SessionSupervisor:
    """Checkpoint / restart of a session's event stream at event boundaries.

    After every ``save_every`` completed events the whole session is saved
    (``checkpoint.save_runtime_session``). A failure mid-event boots a fresh
    runtime from ``make_runtime``, restores the latest boundary into it and
    resumes at the first event past it: at ``save_every=1`` completed events
    never run again and only the failed event re-executes, against the state
    it first saw. ``make_runtime`` is called at every (re)start and may build
    its mesh from whatever devices survive (``elastic_session_mesh``). With ``save_every=k`` up to ``k-1`` completed events re-run
    after a crash. Every exception counts as a restart; past
    ``max_restarts`` it propagates."""

    directory: str
    keep: int = 3
    max_restarts: int = 3
    save_every: int = 1
    on_straggler: Optional[Callable[[int, float], None]] = None
    monitor: StragglerMonitor = dataclasses.field(default_factory=StragglerMonitor)

    def run(self, make_runtime: Callable[[], Any], events) -> tuple[Any, dict]:
        """Run ``events`` (callables ``event(runtime, index) -> result``) to
        the end. Returns the live runtime and {"results": {index: result},
        "restarts": n, "resumed_at": i}; results cover the events this
        process executed."""
        events = list(events)
        ckpt = CheckpointManager(self.directory, keep=self.keep, save_every=self.save_every)

        def boot() -> tuple[Any, int]:
            rt = make_runtime()
            path = latest_checkpoint(self.directory)
            if path is None:
                return rt, 0
            manifest = restore_runtime_session(path, rt)
            return rt, int(manifest["step"])

        restarts = 0
        results: dict[int, Any] = {}
        rt, step = boot()
        resumed_at = step
        while step < len(events):
            try:
                t0 = time.perf_counter()
                results[step] = events[step](rt, step)
                dt = time.perf_counter() - t0
                if self.monitor.record(dt) and self.on_straggler:
                    self.on_straggler(step, dt)
                step += 1
                if step % self.save_every == 0 or step == len(events):
                    save_runtime_session(self.directory, step, rt)
                    ckpt._gc()
            except KeyboardInterrupt:
                raise
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                rt, step = boot()
                resumed_at = step
        return rt, {"results": results, "restarts": restarts, "resumed_at": resumed_at}


@dataclasses.dataclass
class Supervisor:
    """A checkpointed, restartable step loop."""

    ckpt: CheckpointManager
    max_restarts: int = 3
    on_straggler: Optional[Callable[[int, float], None]] = None
    monitor: StragglerMonitor = dataclasses.field(default_factory=StragglerMonitor)

    def run(
        self,
        state: Params,
        step_fn: Callable[[Params, int], Params],
        *,
        num_steps: int,
        start_step: int = 0,
        state_shardings: Optional[Params] = None,
    ) -> Params:
        """Run ``num_steps`` of ``step_fn(state, step) -> state`` with
        checkpoint / restart; ``step_fn`` must not mutate ``state``."""
        restarts = 0
        step = start_step
        restored = self.ckpt.restore_latest(state, shardings=state_shardings)
        if restored is not None:
            state, manifest = restored
            step = int(manifest["step"])
        while step < num_steps:
            try:
                t0 = time.perf_counter()
                state = step_fn(state, step)
                dt = time.perf_counter() - t0
                if self.monitor.record(dt) and self.on_straggler:
                    self.on_straggler(step, dt)
                step += 1
                if self.ckpt.should_save(step):
                    self.ckpt.save(step, state)
            except KeyboardInterrupt:
                raise
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                restored = self.ckpt.restore_latest(state, shardings=state_shardings)
                if restored is None:
                    step = start_step   # no checkpoint yet: restart from the initial state
                    continue
                state, manifest = restored
                step = int(manifest["step"])
        return state
