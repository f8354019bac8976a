"""One driver a traffic mix names: ``Driver(config, params, seed,
device)`` with ``setup()`` (inputs and warm-up) and ``run(seconds,
window)`` (the window), returning a :class:`portbench.program.Outcome`."""
