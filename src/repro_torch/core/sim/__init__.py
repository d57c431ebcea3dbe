"""Discrete-event simulator core (docs/simulator.md).

Three layers, following the engine/domain/policy split:

* **engine** — :mod:`repro_torch.core.sim.kernel`: a lean, allocation-light
  event kernel (typed :class:`Event` records on a binary heap) plus
  :mod:`repro_torch.core.sim.rng` (named seeded RNG streams). The engine knows
  nothing about GPUs, functions, or serving.
* **domain** — :mod:`repro_torch.core.sim.domain` /
  :mod:`repro_torch.core.sim.invocations`: GPU nodes, instances, transfer-leg
  and invocation state machines as explicit event handlers over plain
  slotted classes (no per-event closure chains).
* **policy** — :mod:`repro_torch.core.sim.policies`: scheduler / dispatch /
  transfer knobs as plugin strategy objects, sharing the scoring and key
  code with the threaded daemon byte-for-byte.

:mod:`repro_torch.core.sim.metrics` holds the streaming telemetry aggregates
(reservoir sample + P² percentile sketches) that let a million-invocation
replay keep O(1) memory.

`repro_torch.core.simulator.Simulator` is the façade the rest of the repo
drives; `repro_torch.core.clock.VirtualClock` is a thin façade over
:class:`EventKernel` so pre-existing callers keep working.
"""
from repro_torch.core.sim.kernel import Event, EventKernel, EventKind
from repro_torch.core.sim.rng import RngStreams

__all__ = ["Event", "EventKernel", "EventKind", "RngStreams"]
