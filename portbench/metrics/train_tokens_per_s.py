"""Tokens the window's train steps consumed over its wall seconds."""


def read(run):
    tokens = run.counts.get("tokens")
    return tokens / run.window_s if tokens else None
