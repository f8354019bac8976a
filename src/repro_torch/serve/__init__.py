"""Serving substrate of the port.

* ``protocol_engine`` — the multi-tenant 3P-ADMM-PC2 protocol serving
  engine (port of ``repro.serve.protocol_engine``): many concurrent
  protocol instances on one shared virtual clock, their Paillier ops
  fused across tenants into per-row-modulus kernel launches.
* ``engine`` — the batched greedy-decoding engine over the language
  models of ``repro_torch.models`` (port of ``repro.serve.engine``).
"""
