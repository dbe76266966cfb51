"""Rows the MoE FFN's expert banks compute per row routed to them: the
program's counters ``moe.rows_computed`` (E x C a call, C the capacity)
over ``moe.rows_routed`` (T x k a call), counted from shapes on the host
while a tracing engine ticks (``telemetry.count``), so over the traced
run's ticks, its ramp included.  Exact capacity pads every expert to
T x k rows, so it reads E; an FFN that computes only the routed rows
reads 1.  Nothing where the program keeps no such counter."""


def read(run):
    from repro_torch.serving import telemetry

    counted = getattr(telemetry, "counted", None)
    if counted is None:
        return None
    c = counted()
    routed = c.get("moe.rows_routed", 0)
    if routed <= 0:
        return None
    return c.get("moe.rows_computed", 0) / routed
