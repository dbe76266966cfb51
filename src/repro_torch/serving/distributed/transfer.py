"""Transfer scheduling: host <-> device traffic behind compute, metered.

The paper's distributed claim is that the dual-FPGA pipeline "overlaps
and hides all data transfers".  The serving analogue: every per-tick
transfer (prompt chunks, block-table rows, token ids, lengths, and the
logits coming back) is staged or fetched while a previously dispatched
device computation is still in flight.

:class:`TransferScheduler` is the mechanism and the meter, with the
reference's schedule-level accounting:

  * ``dispatch`` registers a device computation by its outputs (a CUDA
    launch returns before the work completes) and returns an op id;
  * ``stage`` moves a host array to the device(s) (``torch.as_tensor``
    then ``.to(device, non_blocking=True)``), ``fetch`` pulls an op's
    output to host memory; each records one event, **hidden** iff at
    least one dispatched op was still unconsumed at that moment and
    **exposed** otherwise;
  * ``retire`` drops an op whose outputs only feed the next dispatch, so
    it cannot shadow transfers past the tick it ran in;
  * ``note`` meters a transfer made elsewhere (a migration's state copy).

``fetch`` is the only host read of a device tensor in the distributed
tick: a ``.item()`` or ``.cpu()`` anywhere else would synchronize and turn
the "hidden" transfers exposed in wall time without this meter seeing it.
``sync`` waits for every shard's device.  ``overlap_ratio`` is hidden
events over all events (1.0 with no events).  Events are attributed to
the phase the engine declares (``set_phase``: "prefill" for ticks with
prefill work, "drain" for pure-decode ticks), and with a recording
tracer each event is also a span on the trace's transfers track.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.telemetry import NULL_TRACER


def _leaves(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for o in x for t in _leaves(o)]
    if isinstance(x, dict):
        return [t for o in x.values() for t in _leaves(o)]
    return []


class TransferScheduler:
    def __init__(self, tracer=None, devices: Sequence = ()):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        #: the devices ``sync`` waits for
        self.devices = [torch.device(d) for d in devices]
        self._in_flight: Dict[int, List[torch.Tensor]] = {}
        self._next_op = 0
        # recent events only; the aggregate counters stay exact
        self.events: Deque[Tuple[str, int, bool]] = deque(maxlen=16384)
        self.n_hidden = 0
        self.n_exposed = 0
        self.bytes_hidden = 0
        self.bytes_exposed = 0
        self.max_event_bytes = 0
        self._phase = "prefill"
        # phase -> [hidden, exposed, bytes hidden, bytes exposed]
        self._phase_counts: Dict[str, List[int]] = {}

    def reset(self) -> None:
        """Zero the event log; ops in flight keep shadowing."""
        self.events.clear()
        self.n_hidden = self.n_exposed = 0
        self.bytes_hidden = self.bytes_exposed = 0
        self.max_event_bytes = 0
        self._phase_counts = {}

    def set_phase(self, name: str) -> None:
        self._phase = name

    # -- compute registration -------------------------------------------
    def dispatch(self, name: str, *outputs) -> int:
        """Register a device computation by its output tensors; transfers
        recorded while it is unconsumed count as hidden."""
        oid = self._next_op
        self._next_op += 1
        self._in_flight[oid] = _leaves(outputs)
        return oid

    def retire(self, oid: int) -> None:
        self._in_flight.pop(oid, None)

    def sync(self) -> None:
        """Wait for every shard's device; nothing stays in flight."""
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        self._in_flight.clear()

    # -- transfers -------------------------------------------------------
    def _record(self, name: str, nbytes: int, hidden: bool, t0: float,
                kind: str) -> None:
        self.events.append((name, nbytes, hidden))
        ph = self._phase_counts.setdefault(self._phase, [0, 0, 0, 0])
        if hidden:
            self.n_hidden += 1
            self.bytes_hidden += nbytes
            ph[0] += 1
            ph[2] += nbytes
        else:
            self.n_exposed += 1
            self.bytes_exposed += nbytes
            ph[1] += 1
            ph[3] += nbytes
        self.max_event_bytes = max(self.max_event_bytes, nbytes)
        if self.tracer.enabled:
            self.tracer.transfer(name, t0, nbytes, hidden, self._phase, kind)

    def stage(self, name: str, value, devices=None):
        """Host -> device: ``value`` (a host array) to ``devices[s]`` as
        its row ``value[s]`` for each shard s (a list comes back), or
        whole to one device (``devices`` a device).  One event of the
        array's bytes."""
        value = np.ascontiguousarray(value)
        hidden = bool(self._in_flight)
        t0 = time.perf_counter()
        host = torch.from_numpy(value.copy())
        if isinstance(devices, (list, tuple)):
            out = [host[s].to(d, non_blocking=True)
                   for s, d in enumerate(devices)]
        else:
            out = host.to(devices or "cpu", non_blocking=True)
        self._record(name, int(value.nbytes), hidden, t0, "stage")
        return out

    def note(self, name: str, nbytes: int) -> None:
        """Meter a transfer made elsewhere (no copy here)."""
        hidden = bool(self._in_flight)
        self._record(name, int(nbytes), hidden, time.perf_counter(), "note")

    def fetch(self, name: str, value, of: Optional[int] = None
              ) -> torch.Tensor:
        """Device -> host: an op's output (a tensor, or per-shard tensors,
        stacked), as a CPU tensor of its dtype.  ``of`` names the
        producing op, consumed by this fetch; the transfer is hidden iff
        OTHER ops are in flight."""
        if of is not None:
            self._in_flight.pop(of, None)
        hidden = bool(self._in_flight)
        t0 = time.perf_counter()
        if isinstance(value, (list, tuple)):
            out = torch.stack([t.to("cpu") for t in value])
        else:
            out = value.to("cpu")
        self._record(name, out.numel() * out.element_size(), hidden, t0,
                     "fetch")
        return out

    # -- metrics ---------------------------------------------------------
    def overlap_ratio(self) -> float:
        total = self.n_hidden + self.n_exposed
        return self.n_hidden / total if total else 1.0

    def byte_overlap_ratio(self) -> float:
        total = self.bytes_hidden + self.bytes_exposed
        return self.bytes_hidden / total if total else 1.0

    def phase_stats(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for phase, (hid, exp, b_hid, b_exp) in self._phase_counts.items():
            out[phase] = {
                "transfers": hid + exp,
                "transfers_hidden": hid,
                "transfers_exposed": exp,
                "transfer_bytes": b_hid + b_exp,
                "transfer_bytes_hidden": b_hid,
                "transfer_bytes_exposed": b_exp,
                "overlap_ratio": hid / (hid + exp) if hid + exp else 1.0,
            }
        return out

    def stats(self) -> Dict[str, float]:
        out = {
            "transfers": self.n_hidden + self.n_exposed,
            "transfers_hidden": self.n_hidden,
            "transfers_exposed": self.n_exposed,
            "transfer_bytes": self.bytes_hidden + self.bytes_exposed,
            "transfer_bytes_hidden": self.bytes_hidden,
            "transfer_bytes_exposed": self.bytes_exposed,
            "max_transfer_bytes": self.max_event_bytes,
            "overlap_ratio": self.overlap_ratio(),
            "byte_overlap_ratio": self.byte_overlap_ratio(),
        }
        for phase, d in sorted(self.phase_stats().items()):
            out[f"transfers_{phase}"] = d["transfers"]
            out[f"transfers_exposed_{phase}"] = d["transfers_exposed"]
            out[f"overlap_ratio_{phase}"] = d["overlap_ratio"]
        return out
