"""Model FLOPs utilization of the window: the model FLOPs of its train
steps (PaLM's count, ``portbench/counts.lm_train_flops``; no
recomputation) over its wall seconds, over one H100's dense bf16 rate,
in percent."""
from portbench import counts


def read(run):
    tokens = run.counts.get("tokens")
    if not tokens:
        return None
    flops = counts.lm_train_flops(run.inputs["model"], run.inputs["seq"],
                                  tokens)
    return 100.0 * flops / run.window_s / counts.BF16_FLOP_PER_S
