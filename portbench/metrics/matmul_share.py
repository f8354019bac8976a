"""Share of the traced window's device time in matrix-product kernels
outside attention (the layers' and the head's weight products, forward,
recomputed and backward; ``trace.GEMM`` by kernel name), in percent."""
from portbench.readers import gemm_share


def read(run):
    return gemm_share(run, exclude=("layers.attention",))
