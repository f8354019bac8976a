"""Share of the traced window's device time in the operations that the
AdamW update launched (``optimizer.adamw_update``), in percent."""
from portbench.readers import span_share


def read(run):
    return span_share(run, "optimizer.adamw_update")
