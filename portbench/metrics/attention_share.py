"""Share of the traced window's device time in the operations that the
model's attention launched (``layers.attention``: its products, masking
and softmax, forward, recomputed and backward), in percent."""
from portbench.readers import span_share

SPAN = "layers.attention"


def read(run):
    return span_share(run, SPAN)
