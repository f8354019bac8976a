"""repro_torch's private-LASSO protocol vs the JAX reference, end to end.

LASSO at the conformance sizes (K, N, ITERS, KEY_BITS = 4, 32, 3, 128 —
``tests/test_conformance.py``) runs through ``repro.core.protocol`` and
``repro_torch.core.protocol`` (``device="cpu"``: the kernels' plain
versions) under four arms: plain, gold batched, gold scalar and gold
batched under ``REPRO_REDUCE_IMPL=barrett`` (Barrett ladders throughout,
set for both packages for that arm only).  The two
packages must agree with zero tolerance — integer and float64 work in
the same order — in the history bytes, the ordered ciphertext stream,
the blinding rng's final state and the RunReport core.

Also here: the port refuses ``device="cuda"`` without a card instead of
running on the CPU (``run_protocol`` and the runtime's
``run_on_runtime``), hands ``deadline`` mode and ``cipher="auto"`` to the
event-driven runtime as the reference does (and equals the reference's
runs), and imports neither JAX nor the reference package anywhere.
"""
import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.core import protocol as rproto
from repro.core.cipher_tensor import CipherTensor as RCipherTensor
from repro.core.quantization import QuantSpec as RQuantSpec
from repro.obs.metrics import report_core as rreport_core
from repro_torch.core import bigint as bi
from repro_torch.core import cipher_tensor as ctm
from repro_torch.core import protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.obs.metrics import report_core

# small tensors: one intra-op thread avoids oversubscribing the cores that
# the suite's parallel workers share
torch.set_num_threads(1)

K, N, ITERS, KEY_BITS = 4, 32, 3, 128
SPEC = dict(delta=1e6, zmin=-8.0, zmax=8.0)
ARMS = {"plain": dict(cipher="plain"),
        "gold_scalar": dict(cipher="gold", gold_batch=False),
        "gold_batch": dict(cipher="gold", gold_batch=True),
        "gold_batch_barrett": dict(cipher="gold", gold_batch=True)}
#: the reduction each arm runs under (REPRO_REDUCE_IMPL); default otherwise
ARM_REDUCE = {"gold_batch_barrett": "barrett"}
GOLD_ARMS = [arm for arm, kw in ARMS.items() if kw["cipher"] == "gold"]
REPO = pathlib.Path(__file__).resolve().parents[1]


class RecordingBox:
    """Delegating wrapper that records the emitted ciphertext stream."""

    def __init__(self, box):
        self._box = box
        self.enc_stream: list[int] = []

    def __getattr__(self, attr):
        return getattr(self._box, attr)

    def encrypt(self, m):
        c = self._box.encrypt(m)
        if isinstance(c, ctm.CipherTensor):    # decode, leave it resident
            ints = bi.to_ints(c.limbs)
        elif isinstance(c, RCipherTensor):
            ints = c.to_ints()
        else:
            ints = [int(x) for x in c]
        self.enc_stream.extend(ints)
        return c


def _cfg(module, spec_cls, **kw):
    return module.ProtocolConfig(K=K, lam=0.05, iters=ITERS,
                                 spec=spec_cls(**SPEC), seed=0,
                                 key_bits=KEY_BITS, **kw)


@pytest.fixture(scope="module")
def inst():
    return make_lasso(24, N, sparsity=0.1, noise=0.01, seed=1)


@pytest.fixture(scope="module")
def runs(inst):
    """Every arm through both packages, each with its recorded box."""
    mp = pytest.MonkeyPatch()
    out = {}
    for pkg, module, spec_cls in (("ref", rproto, RQuantSpec),
                                  ("port", protocol, QuantSpec)):
        recorders = {}
        real = module.make_box

        def recording_make_box(*a, _real=real, _rec=recorders, **kw):
            box, key = _real(*a, **kw)
            _rec["box"] = RecordingBox(box)
            return _rec["box"], key

        mp.setattr(module, "make_box", recording_make_box)
        try:
            for arm, kw in ARMS.items():
                if arm in ARM_REDUCE:
                    mp.setenv("REPRO_REDUCE_IMPL", ARM_REDUCE[arm])
                else:
                    mp.delenv("REPRO_REDUCE_IMPL", raising=False)
                extra = {"device": "cpu"} if pkg == "port" else {}
                ctm.reset_conversion_stats()
                res = module.run_protocol(inst.A, inst.y,
                                          _cfg(module, spec_cls, **kw),
                                          **extra)
                out[pkg, arm] = (res, recorders.pop("box"))
                out[pkg, arm, "conversions"] = dict(ctm.CONVERSIONS)
        finally:
            mp.undo()
    return out


@pytest.mark.parametrize("arm", ARMS)
def test_history_bytes_equal_reference(runs, arm):
    ref, port = runs["ref", arm][0], runs["port", arm][0]
    assert port.history.tobytes() == ref.history.tobytes()
    assert np.array_equal(port.x, ref.x)
    # Paillier is exact: every arm equals the plain integer chain
    assert port.history.tobytes() == runs["port", "plain"][0].history.tobytes()


@pytest.mark.parametrize("arm", ARMS)
def test_ciphertext_stream_equal_reference(runs, arm):
    ref, port = runs["ref", arm][1], runs["port", arm][1]
    assert len(port.enc_stream) == K * (N // K) * (1 + 2 * ITERS)
    assert port.enc_stream == ref.enc_stream


@pytest.mark.parametrize("arm", GOLD_ARMS)
def test_rng_state_equal_reference(runs, arm):
    assert runs["port", arm][1].rng.getstate() == \
        runs["ref", arm][1].rng.getstate()


@pytest.mark.parametrize("arm", ARMS)
def test_report_core_equal_reference(runs, arm):
    ref, port = runs["ref", arm][0], runs["port", arm][0]
    assert report_core(port.stats) == rreport_core(ref.stats)
    secs = port.stats["seconds"]
    assert len(secs["rounds"]) == ITERS and secs["iterate"] >= 0.0


def test_gold_batch_converts_only_at_phase_boundaries(runs):
    """The limb-resident arm never materializes a ciphertext to ints nor
    re-packs one between protocol ops (the recorder decodes limbs
    without touching the CipherTensor)."""
    assert runs["port", "gold_batch", "conversions"] == \
        {"to_ints": 0, "from_ints": 0}


def test_recycled_updates_equal_reference(inst):
    kw = dict(cipher="plain", recycle=True, recycle_tol=10 ** 6, iters=4)
    ref = rproto.run_protocol(inst.A, inst.y, dataclasses.replace(
        _cfg(rproto, RQuantSpec), **kw))
    port = protocol.run_protocol(inst.A, inst.y, dataclasses.replace(
        _cfg(protocol, QuantSpec), **kw), device="cpu")
    assert port.history.tobytes() == ref.history.tobytes()
    assert report_core(port.stats) == rreport_core(ref.stats)
    assert port.stats["churn"]["recycled"] > 0


@pytest.mark.parametrize("arm", ("plain", "gold_batch"))
def test_cuda_without_card_raises(inst, arm):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the valid default here")
    cfg = _cfg(protocol, QuantSpec, **ARMS[arm])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        protocol.run_protocol(inst.A, inst.y, cfg)


def _auto_table(kinds) -> dict:
    """A calibration table for the K = 4, Nk = 8, 128-bit runs under each
    device kind of ``kinds``: enc/dec cheapest on scalar gold, ⊕ and the
    matvec on vec."""
    cheap = {"gold": ("enc", "dec"), "gold_batch": (),
             "vec": ("add", "matvec")}
    return {"version": 3, "entries": {
        f"{kind}/{b}/{KEY_BITS}/{N // K}": {
            **{op: 1e-6 if op in ops else 1e-3
               for op in ("enc", "add", "matvec", "dec")},
            "convert": 1e-8}
        for kind in kinds for b, ops in cheap.items()}}


@pytest.mark.parametrize("kw", [dict(cipher="auto"),
                                dict(deadline=0.5,
                                     latency_fn=lambda k, t: 0.3 * k)])
def test_runtime_modes_delegate_to_the_runtime(inst, kw, tmp_path,
                                               monkeypatch):
    """``deadline`` and ``cipher="auto"`` run on the event-driven runtime
    (the auto run on a calibration cache holding a hand-built table under
    both packages' device kinds, so neither measures) and equal the
    reference's runs."""
    from repro.runtime.dispatch import device_kind as rdevice_kind
    calib = tmp_path / "calib.json"
    calib.write_text(json.dumps(_auto_table(("torch-cpu",
                                             rdevice_kind()))))
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(calib))
    ref = rproto.run_protocol(inst.A, inst.y, _cfg(rproto, RQuantSpec, **kw))
    port = protocol.run_protocol(inst.A, inst.y,
                                 _cfg(protocol, QuantSpec, **kw),
                                 device="cpu")
    assert port.history.tobytes() == ref.history.tobytes()
    assert port.stale_events == ref.stale_events
    assert report_core(port.stats) == rreport_core(ref.stats)
    r, p = ref.stats["runtime"], port.stats["runtime"]
    for key in ("mode", "virtual_time", "iter_times", "events", "launches",
                "coalesced_ops", "held_flushes", "link_bytes"):
        assert p[key] == r[key], key
    assert p.get("dispatch") == r.get("dispatch")
    if kw.get("cipher") == "auto":
        assert p["dispatch"] == {"add:vec": 2 * K * ITERS,
                                 "dec:gold": K * ITERS,
                                 "enc:gold": K * (1 + 2 * ITERS),
                                 "matvec:vec": K * ITERS}
        loads = [e for e in p["profile"] if e["kind"] == "calibrate"]
        assert loads[-1]["measured"] == 0
    else:
        assert p["mode"] == "deadline" and port.stale_events > 0


def test_run_on_runtime_cuda_without_card_raises(inst):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the valid default here")
    from repro_torch.runtime.runner import run_on_runtime
    cfg = _cfg(protocol, QuantSpec)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            run_on_runtime(inst.A, inst.y, cfg, device=device)


def test_port_imports_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert hits == []
