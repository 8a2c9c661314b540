"""Is the overlap engine's communication interleaved with compute?  Read
from a ``torch.profiler`` trace (the counterpart of what
``repro.core.hlo_inspect.interleave_report`` checks on the lowered HLO).

The reference verifies the overlap engine on the program XLA is given:
a pipelined program emits all-to-alls *between* the compute stages of
consecutive chunks, while the sequential communicate → compute →
communicate program has one collective run before its compute and one
after.  Eager torch has no such program; what it has is the host's issue
order, which the profiler records.  :func:`interleave_report` classifies
a trace's host events in start order:

* a **collective** is an ``all_to_all_single`` call — the
  ``c10d::alltoall_base_`` op it dispatches (gloo and NCCL alike; the
  async issue of an overlap round counts where it is issued);
* a **compute** stage is a ``torch.profiler.record_function`` span
  around it — the MoE's expert FFN, ``models.moe.EXPERT_SPAN``.  The
  port's kernels are launched through ``ctypes``, not as aten ops, so a
  named span is the stable mark.

Only host events count: on a card the profiler also records each
``record_function`` span as a device-side annotation of the same name,
at the device's time.

The HLO-only parts of ``hlo_inspect`` (``parse_hlo``, the loop-aware byte
counts) have no torch counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from torch.autograd import DeviceType

# The op ``torch.distributed.all_to_all_single`` dispatches.
COLLECTIVE_OP = "c10d::alltoall_base_"
# The MoE's expert-FFN span (``models.moe.EXPERT_SPAN``; a string here so
# that this module imports nothing of the model).
EXPERT_SPAN = "repro_torch.moe.expert_ffn"


@dataclass
class InterleaveReport:
    """Host-order interleaving of collectives and compute stages.

    ``events`` is the trace filtered to collective / compute events, in
    start order, as ``(class, name)`` pairs.
    """
    events: list[tuple[str, str]] = field(default_factory=list)  # (cls, op)

    @property
    def runs(self) -> list[tuple[str, int]]:
        """Run-length encoding of the event classes."""
        out: list[tuple[str, int]] = []
        for cls, _ in self.events:
            if out and out[-1][0] == cls:
                out[-1] = (cls, out[-1][1] + 1)
            else:
                out.append((cls, 1))
        return out

    @property
    def collective_runs(self) -> int:
        """Maximal collective runs separated by compute.  Sequential
        comm->compute->comm programs have <= 2; a pipelined program has
        one extra run per interleaved chunk boundary."""
        return sum(1 for cls, _ in self.runs if cls == "collective")

    @property
    def interleaved_collectives(self) -> int:
        """Collectives with a compute stage both before AND after them in
        host order — the rounds the schedule can hide behind compute."""
        classes = [cls for cls, _ in self.events]
        try:
            first = classes.index("compute")
            last = len(classes) - 1 - classes[::-1].index("compute")
        except ValueError:
            return 0
        return sum(1 for cls in classes[first + 1:last]
                   if cls == "collective")


def interleave_report(events) -> InterleaveReport:
    """Classify a profiler trace's host events into collectives
    (:data:`COLLECTIVE_OP`) and compute (:data:`EXPERT_SPAN`), in start
    order.

    ``events``: a ``torch.profiler.profile`` that has run, or its
    ``events()`` list (``FunctionEvent`` s with ``name``,
    ``device_type`` and ``time_range``).
    """
    if hasattr(events, "events"):
        events = events.events()
    rep = InterleaveReport()
    host = [ev for ev in events if ev.device_type == DeviceType.CPU]
    for ev in sorted(host, key=lambda e: e.time_range.start):
        if ev.name == COLLECTIVE_OP:
            rep.events.append(("collective", ev.name))
        elif ev.name == EXPERT_SPAN:
            rep.events.append(("compute", ev.name))
    return rep


__all__ = ["COLLECTIVE_OP", "EXPERT_SPAN", "InterleaveReport",
           "interleave_report"]
