"""Device-idle seconds a train step charged to the MoE layer's host work:
the program's ``moe.*`` spans (``idle_gaps`` of the trace, over
``run.counts["steps"]``).

A gap is charged to the innermost host event open at its middle, so
idle under one of the layer's operators (an ``aten::sort`` inside
``moe.route``) is the operator's, not the span's: the reading counts the
host's Python between the layer's operators, and the trace's breakdown
keeps only its ten largest gaps.  ``None`` without a trace, and where
the program has no ``moe.*`` span (``repro_torch.obs.trace.SPANS``) to
name its steps.
"""
#: the program's span names counted, by prefix
PROGRAM = ("moe.",)
#: the harness's labels counted, by prefix (none)
HARNESS = ()


def names() -> set | None:
    from repro_torch.obs import trace
    found = {n for n in getattr(trace, "SPANS", ()) if n.startswith(PROGRAM)}
    return found or None


def read(run):
    counted = names()
    steps = run.counts.get("steps")
    if run.trace is None or counted is None or not steps:
        return None
    return sum(s for name, s in run.trace.idle_gaps
               if name in counted) / steps
