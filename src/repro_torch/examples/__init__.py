"""The reference's six examples, on the port.

Each module runs as ``python -m repro_torch.examples.<name> [--device
cpu]`` (the card by default; without a card the default exits with
``resolve_device``'s message) and has a ``main(argv=None)``.  It keeps
the script's constants, seeds and asserts and prints its lines in its
format; only timing fields differ.  On the CPU, with the same seed, the
protocol examples print the reference's results exactly.  The LM
examples start from the port's own seeded weights.

- ``quickstart``: gold Paillier LASSO, K = 3, against distributed ADMM;
- ``edge_network_sim``: the runtime's star, lossy hierarchical and
  deadline-with-straggler runs;
- ``workload_zoo``: every registered ADMM family through the protocol;
- ``power_grid_reconstruction``: the paper's §V-C topology recovery;
- ``serve_batched``: batched greedy decode on the ``Engine``;
- ``train_lm_secure``: xLSTM training, with Γ-compressed data parallel
  gradients over more than one rank.
"""
from __future__ import annotations

import argparse

from .. import resolve_device


def parse_args(doc: str, argv=None, add=None) -> argparse.Namespace:
    """The example's arguments: ``--device`` (resolved; exits when the
    card is asked for and absent) and whatever ``add(parser)`` adds."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    if add is not None:
        add(ap)
    args = ap.parse_args(argv)
    try:
        args.device = str(resolve_device(args.device))
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"{ap.prog}: {e}") from None
    return args
