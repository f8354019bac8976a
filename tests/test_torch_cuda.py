"""repro_torch CUDA kernels vs their plain PyTorch versions, on the card.

Every instantiation of the three hand-written kernels (mulmod; modexp's
four (reduction x window) bodies; modexp_fixed's two) is held against its
plain version on the same CUDA tensors and against Python ints, at small
widths including an odd-byte modulus with full-width operands, and at
ragged batch sizes, and a small protocol run on the card is held against
the same run on the CPU.  These tests need an NVIDIA card and skip without
one; on the card run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.core import bigint as bi
from repro_torch.core import protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.obs.metrics import report_core
from repro_torch.kernels import build, ops
from repro_torch.kernels import limb_mulmod as lm
from repro_torch.kernels import modexp as mx

pytestmark = pytest.mark.cuda

BITS = (24, 200, 1000, 2048)     # 24 and 1000 bits: odd byte lengths
BATCHES = (1, 5, 130)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _odd_modulus(bits: int) -> int:
    return random.Random(bits).getrandbits(bits) | (1 << (bits - 1)) | 1


def _rows(rng, B, L, dev):
    """Full-width operands: any value below 2^{16 L}, not reduced mod m."""
    ints = [rng.getrandbits(16 * L) for _ in range(B)]
    return ints, torch.as_tensor(bi.from_ints(ints, L), device=dev)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("B", BATCHES)
def test_mulmod_kernel_matches_plain_and_ints(dev, bits, B):
    m = _odd_modulus(bits)
    pack = ops.pack_modulus(m)
    dm = pack.on(dev)
    rng = random.Random(bits * 7 + B)
    a, at = _rows(rng, B, pack.L16, dev)
    b, bt = _rows(rng, B, pack.L16, dev)
    out = lm.mulmod_cuda(at, bt, dm)
    torch.cuda.synchronize()
    assert torch.equal(out, lm.mulmod_plain(at, bt, dm))
    assert bi.to_ints(out) == [(x * y) % m for x, y in zip(a, b)]


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("impl", ("montgomery", "barrett"))
@pytest.mark.parametrize("method", ("win4", "binary"))
def test_modexp_kernel_matches_plain_and_ints(dev, bits, impl, method):
    m = _odd_modulus(bits)
    pack = ops.pack_modulus(m)
    dm = pack.on(dev)
    rng = random.Random(bits)
    base, bt = _rows(rng, 5, pack.L16, dev)
    exps, et = _rows(rng, 5, 4, dev)
    exps[0] = 0
    et[0] = 0
    out = mx.modexp_cuda(bt, et, dm, method, impl)
    torch.cuda.synchronize()
    assert torch.equal(out, mx.modexp_plain(bt, et, dm, method, impl))
    assert bi.to_ints(out) == [pow(x, e, m) for x, e in zip(base, exps)]


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("impl", ("montgomery", "barrett"))
def test_modexp_fixed_kernel_matches_plain_and_ints(dev, bits, impl):
    m = _odd_modulus(bits)
    pack = ops.pack_modulus(m)
    dm = pack.on(dev)
    rng = random.Random(bits + 1)
    base, bt = _rows(rng, 5, pack.L16, dev)
    e = rng.getrandbits(bits)
    windows = ops.mg.exp_windows(e)
    out = mx.modexp_fixed_cuda(bt, windows, dm, impl)
    torch.cuda.synchronize()
    assert torch.equal(out, mx.modexp_fixed_plain(bt, windows, dm, impl))
    assert bi.to_ints(out) == [pow(x, e, m) for x in base]


def test_even_modulus_and_empty_batch_on_card(dev):
    m = _odd_modulus(300) - 1
    pack = ops.pack_modulus(m)
    rng = random.Random(3)
    base, bt = _rows(rng, 9, pack.L16, dev)
    exps, et = _rows(rng, 9, 2, dev)
    before = dict(build.LAUNCHES)
    out = ops.modexp(bt, et, pack)
    assert bi.to_ints(out) == [pow(x, e, m) for x, e in zip(base, exps)]
    assert bi.to_ints(ops.modexp_fixed(bt, 12345, pack)) == \
        [pow(x, 12345, m) for x in base]
    assert ops.mulmod(bt[:0], bt[:0], pack).shape == (0, pack.L16)
    assert bi.to_ints(ops.modexp_fixed(bt, 0, pack)) == [1] * 9
    assert build.LAUNCHES["modexp"] == before["modexp"] + 1
    assert build.LAUNCHES["modexp_fixed"] == before["modexp_fixed"] + 1
    assert build.LAUNCHES["mulmod"] == before["mulmod"]


def test_protocol_on_card_equals_cpu_run(dev):
    """The gold-batched LASSO protocol on the card gives the CPU run's
    history bytes and RunReport core (small key), launching every kernel."""
    inst = make_lasso(24, 32, sparsity=0.1, noise=0.01, seed=1)
    cfg = protocol.ProtocolConfig(K=4, lam=0.05, iters=2, seed=0,
                                  spec=QuantSpec(1e6, -8.0, 8.0),
                                  cipher="gold", key_bits=128)
    build.reset_launches()
    on_card = protocol.run_protocol(inst.A, inst.y, cfg)
    assert all(n > 0 for n in build.LAUNCHES.values()), build.LAUNCHES
    on_cpu = protocol.run_protocol(inst.A, inst.y, cfg, device="cpu")
    assert on_card.history.tobytes() == on_cpu.history.tobytes()
    assert report_core(on_card.stats) == report_core(on_cpu.stats)
    assert np.all(np.isfinite(on_card.history))
