"""What a ``torch.profiler`` run saw on the device.

``read(prof)`` takes the profiler's events
(``prof.profiler.kineto_results.events()``, whose methods are the same on
torch 2.11 and 2.13) and returns:

  * ``busy_s``: the length of the union of the device's activity
    intervals (kernels, copies, sets);
  * per host range name (``record_function`` ranges, the engine's and the
    benchmark's), the device seconds and launches of the activities
    launched from inside it.  A device activity shares its correlation id
    with the host call that launched it (``cudaLaunchKernel``,
    ``cudaLaunchKernelExC`` for the port's ``ctypes`` launches,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``...); it belongs to the
    innermost range open at that call's start;
  * ``device_ops``: device seconds per activity name;
  * ``idle``: the device's idle seconds between activities, by what the
    host was doing at the middle of each gap (the innermost range and the
    innermost operator open there).

``device_busy(prof)`` reads only the first: the union of the device's
activity intervals of a profiler that recorded the device alone.

The correlation rule and the union of intervals are copies of the
port's ``serving/telemetry.py`` ``profile_ranges`` and ``launch/serve.py``
``_busy_us``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def union(intervals: List[Tuple[int, int]]) -> Tuple[int, List]:
    """Length of the union of ``(start, end)`` intervals and the merged
    intervals, in order."""
    total, merged = 0, []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                total += b - merged[-1][1]
                merged[-1][1] = b
        else:
            total += b - a
            merged.append([a, b])
    return total, merged


def _stab(ranges: List[Tuple[int, int, str]], queries: List[Tuple[int, object]]
          ) -> Dict[object, str]:
    """For each ``(time, key)`` query, the name of the innermost range
    ``(start, end, name)`` open at that time (ranges nest: one thread)."""
    ev = []
    for i, (a, b, _) in enumerate(ranges):
        ev.append((a, 0, i))
        ev.append((b, 2, i))
    for t, key in queries:
        ev.append((t, 1, key))
    ev.sort(key=lambda e: (e[0], e[1]))
    stack: List[int] = []
    out: Dict[object, str] = {}
    for _, kind, x in ev:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            if stack and stack[-1] == x:
                stack.pop()
            elif x in stack:
                stack.remove(x)
        elif stack:
            out[x] = ranges[stack[-1]][2]
    return out


def _is_launch(name: str) -> bool:
    return ("Launch" in name or name.startswith("cudaMemcpy")
            or name.startswith("cudaMemset") or name.startswith("cuMemcpy")
            or name.startswith("cuMemset"))


def read(prof) -> Dict:
    from torch.autograd import DeviceType

    annotations, ops, launches, device = [], [], [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU:
            name = ev.name()
            if ev.is_user_annotation():
                annotations.append((ev.start_ns(), ev.end_ns(), name))
            elif _is_launch(name):
                launches.append((ev.start_ns(), ev.correlation_id()))
            else:
                ops.append((ev.start_ns(), ev.end_ns(), name))
        elif not ev.is_user_annotation():
            device.append((ev.name(), ev.start_ns(), ev.end_ns(),
                           ev.correlation_id()))
    owner = _stab(annotations, [(t, c) for t, c in launches])
    ranges: Dict[str, Dict] = {}
    names: Dict[str, float] = {}
    for name, a, b, corr in device:
        r = ranges.setdefault(owner.get(corr), {"device_s": 0.0,
                                                "launches": 0})
        r["device_s"] += (b - a) * 1e-9
        r["launches"] += 1
        names[name] = names.get(name, 0.0) + (b - a) * 1e-9
    busy_ns, merged = union([(a, b) for _, a, b, _ in device])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    mids = [((a + b) // 2, i) for i, (a, b) in enumerate(gaps)]
    in_range = _stab(annotations, mids)
    in_op = _stab(ops, mids)
    idle: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        key = (f"{in_range.get(i, 'outside ranges')}"
               f" / {in_op.get(i, 'no operator')}")
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-9
    return {"busy_s": busy_ns * 1e-9, "ranges": ranges,
            "device_ops": names, "idle": idle,
            "n_device": len(device)}


def device_busy(prof) -> Dict:
    """``busy_s``, the union of the device's activity intervals in
    ``prof``; ``n_device``, their number; ``span_s``, from the first's
    start to the last's end."""
    from torch.autograd import DeviceType

    iv = [(ev.start_ns(), ev.end_ns())
          for ev in prof.profiler.kineto_results.events()
          if ev.device_type() != DeviceType.CPU
          and not ev.is_user_annotation()]
    busy_ns, merged = union(iv)
    span = merged[-1][1] - merged[0][0] if merged else 0
    return {"busy_s": busy_ns * 1e-9, "n_device": len(iv),
            "span_s": span * 1e-9}


#: the least share of a traced part's wall that its device activities
#: have to span: a tracer that ran out of buffers stops recording early
COVERED = 0.5


def check_covered(part: Dict) -> None:
    """Raise where a traced part's device activities span less than
    ``COVERED`` of its wall time: its busy time would be counted short."""
    if part["span_s"] < COVERED * part["wall_s"]:
        raise RuntimeError(
            f"the device trace spans {part['span_s']:.3f} s of a part of "
            f"{part['wall_s']:.3f} s ({part['n_device']} activities): the "
            "tracer stopped recording")


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
