"""Model zoo of the port: dense/MoE decoder LMs, enc-dec, xLSTM, Griffin
(RG-LRU), VLM backbone.

PyTorch ports of ``repro.models``: ``init_params(cfg, seed, device)``
builds a :class:`~.layers.Params` tree of float32 parameters and
``forward``/``prefill``/``decode_step`` apply it.  See ``registry.py``.
"""
