"""Times the MoE layer's host waited on the card, per call of the layer:
the process's ``wait.moe.*`` counts over its ``moe.calls`` count
(``repro_torch.obs.metrics.PROCESS``).  The reader runs in the program's
process, after the window; the warm-up's calls are counted too, and the
ratio is the same for both.  A path that never waits reads 0.  ``None``
where the layer never ran (the program has no such counter).
"""


def read(run):
    from repro_torch.obs import metrics
    counters = metrics.PROCESS.counters
    calls = counters.get("moe.calls", 0)
    if not calls:
        return None
    return sum(n for name, n in counters.items()
               if name.startswith("wait.moe.")) / calls
