"""Device-idle seconds a tenant-round charged to the coalescer's host
work: the program's ``coalescer.*`` spans and what is left under the
harness's ``coalesce.*`` labels (``idle_gaps`` of the trace, over
``run.tenant_rounds``).

The trace's breakdown keeps only its ten largest gaps, so the reading is
a lower bound.  ``None`` without a trace, and where the program has no
span table (``repro_torch.obs.trace.SPANS``) to name its steps.
"""
#: the program's span names counted, by prefix
PROGRAM = ("coalescer.",)
#: the harness's labels counted, by prefix (``portbench.spans.labels()``)
HARNESS = ("coalesce.",)


def names() -> set | None:
    from portbench import spans
    from repro_torch.obs import trace
    table = getattr(trace, "SPANS", None)
    if table is None:
        return None
    return {n for n in table if n.startswith(PROGRAM)} \
        | {n for n in spans.labels() if n.startswith(HARNESS)}


def read(run):
    counted = names()
    if run.trace is None or counted is None or not run.tenant_rounds:
        return None
    return sum(s for name, s in run.trace.idle_gaps
               if name in counted) / run.tenant_rounds
