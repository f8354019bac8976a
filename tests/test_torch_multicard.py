"""The multi-card batch split and the last reference names, on the CPU.

``launch.mesh.kernel_mesh`` is ``None`` on the CPU and on one card, and
``runtime.dispatch.device_kind`` then has no ``xN`` suffix; under a
monkeypatched card count both change as the reference's do
(``tests/test_montgomery.py``).  With ``kernel_mesh`` ``None``,
``core.paillier_batch._shard_batch`` hands its inputs back untouched.
The split itself is rehearsed by monkeypatching ``kernel_mesh`` to two
or three CPU devices: ``enc_ct``, ``dec_vec``, ``matvec_many`` and a
whole gold ``run_protocol`` must equal the unsplit run and the
reference with zero tolerance (ciphertexts, histories, the blinding rng's
state, the RunReport core), and each CRT body must really have run in
chunks.  A batch the device count does not divide stays whole.

Also here: ``kernels.ref.fft_mul_ref`` against the reference's (radix
2^8 there, 2^16 here: compared as integers), the dry-run report's
``torch`` key, ``launch._rerun_cells`` merging a cell into a report and
refusing one that another torch release produced, and
``launch._probe_mem``'s flags.
"""
import json
import random

import numpy as np
import pytest
import torch

from repro.core import paillier as rgold
from repro.core import paillier_batch as rpb
from repro.core import protocol as rproto
from repro.core.quantization import QuantSpec as RQuantSpec
from repro.kernels import ref as rref
from repro.obs.metrics import report_core as rreport_core
from repro_torch.core import bigint as bi
from repro_torch.core import paillier as gold
from repro_torch.core import paillier_batch as pb
from repro_torch.core import paillier_vec as pv
from repro_torch.core import protocol
from repro_torch.core.cipher_tensor import CipherTensor
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.kernels import ref
from repro_torch.launch import _probe_mem, _rerun_cells, dryrun
from repro_torch.launch import mesh
from repro_torch.obs.metrics import report_core
from repro_torch.runtime import dispatch

torch.set_num_threads(1)

KEY_BITS = 128
# K = 3 edges of Nk = 12: every enc/dec batch and the matvec's rows split
# evenly over two and over three devices
K, N, M, ITERS = 3, 36, 24, 2
SPEC = dict(delta=1e6, zmin=-8.0, zmax=8.0)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def keys():
    return (gold.keygen(KEY_BITS, random.Random(7)),
            rgold.keygen(KEY_BITS, random.Random(7)))


@pytest.fixture
def split(monkeypatch):
    """Monkeypatch ``kernel_mesh`` to ``n`` CPU devices; records the batch
    of every CRT body run (``crt_combine_batch``'s rows)."""
    bodies = []
    real = pv.crt_combine_batch

    def spy(vk, xp, xq):
        bodies.append(int(xp.shape[0]))
        return real(vk, xp, xq)

    monkeypatch.setattr(pv, "crt_combine_batch", spy)

    def set_cards(n):
        monkeypatch.setattr(mesh, "kernel_mesh",
                            lambda device=None: [CPU] * n if n > 1 else None)
        bodies.clear()
        return bodies
    return set_cards


def test_kernel_mesh_and_device_kind_suffix(monkeypatch):
    assert mesh.kernel_mesh("cpu") is None
    assert dispatch.device_kind("cpu") == "torch-cpu"
    if torch.cuda.device_count() <= 1:
        assert mesh.kernel_mesh() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "H/X")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.kernel_mesh() is None
    assert dispatch.device_kind() == "torch-cuda-H-X"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.kernel_mesh() == [torch.device("cuda", i) for i in range(4)]
    assert mesh.kernel_mesh("cpu") is None
    assert dispatch.device_kind() == "torch-cuda-H-Xx4"
    assert dispatch.device_kind("cpu") == "torch-cpu"


def test_shard_batch_single_device_passthrough():
    x = torch.ones((4, 3), dtype=torch.int32)
    assert pb._shard_batch(x) is x
    y = torch.zeros((2, 3), dtype=torch.int32)
    a, b = pb._shard_batch(x, y)
    assert a is x and b is y


@pytest.mark.parametrize("cards", [2, 3])
def test_shard_batch_chunks_and_indivisible_batches(split, cards):
    split(cards)
    x = torch.arange(12 * 2).reshape(12, 2)
    shards = pb._shard_batch(x, x + 1)
    assert isinstance(shards, pb.Shards) and len(shards) == cards
    rows = 12 // cards
    for i, (card, (a, b)) in enumerate(shards):
        assert card == CPU
        assert torch.equal(a, x[i * rows:(i + 1) * rows])
        assert torch.equal(b, a + 1)
    # whole groups only: 12 rows in groups of 6 split over two, not three
    assert isinstance(pb._shard_batch(x, group=6), pb.Shards) == (cards == 2)
    odd = torch.ones((12 + 1, 2))
    assert pb._shard_batch(odd) is odd
    assert pb._shard_batch(odd, odd)[1] is odd


def _batched_ops(key_port, key_ref, B):
    """enc, dec and matvecs (resident, int, negative exponents) through
    both packages on the same inputs and rng streams."""
    ms = list(range(-B // 2, B - B // 2))
    Ks = np.random.default_rng(3).integers(0, 5000, (2, 6, B // 2))
    Kn = Ks.copy()
    Kn[1, 2, 0] = -4                      # forces the materialized path
    out = {}
    for pkg, mod, key, extra in (("port", pb, key_port, {"device": "cpu"}),
                                 ("ref", rpb, key_ref, {})):
        bk = mod.make_batch_key(key, **extra)
        rng = random.Random(11)
        ct = mod.enc_ct(bk, ms, rng)
        ints = ct.to_ints()
        half = B // 2
        rows = [mod.CipherTensor.from_ints(bk, ints[:half]) if pkg == "ref"
                else CipherTensor.from_ints(bk, ints[:half]),
                ints[half:]]
        res = {"enc": ints, "dec": mod.dec_vec(bk, ct),
               "rng": rng.getstate(),
               "mv_ct": [r.to_ints() for r in mod.matvec_many(
                   bk, Ks.astype(object), [rows[0], rows[0]])],
               "mv_int": mod.matvec_many(bk, Ks.astype(object),
                                         [rows[1], rows[1]]),
               "mv_neg": mod.matvec_many(bk, Kn.astype(object),
                                         [rows[1], rows[1]])}
        out[pkg] = res
    return out


@pytest.mark.parametrize("cards", [2, 3])
def test_split_batched_ops_equal_unsplit_and_reference(split, keys, cards):
    B = 12
    whole = _batched_ops(*keys, B)
    assert whole["port"] == whole["ref"]
    bodies = split(cards)
    got = _batched_ops(*keys, B)["port"]
    assert got == whole["port"]
    # enc and dec ran in chunks of B / cards, the matvecs' 12 output rows
    # (2 edges x 6) in chunks of 12 / cards rows of B / 2 factors
    assert bodies.count(B // cards) >= 2
    assert bodies.count(12 * (B // 2) // cards) == 3 * cards


def test_split_leaves_an_indivisible_batch_whole(split, keys):
    bodies = split(2)
    bk = pb.make_batch_key(keys[0], "cpu")
    c = pb.enc_ct(bk, [1, 2, 3, 4, 5], random.Random(0))
    assert bodies == [5]
    assert pb.dec_vec(bk, c) == [1, 2, 3, 4, 5]


def _gold_run(module, spec_cls, inst, **kw):
    cfg = module.ProtocolConfig(K=K, lam=0.05, iters=ITERS,
                                spec=spec_cls(**SPEC), seed=0,
                                key_bits=KEY_BITS, cipher="gold", **kw)
    rec = {}
    real = module.make_box

    def make_box(*a, **k):
        box, key = real(*a, **k)
        rec["box"] = box
        return box, key
    module.make_box = make_box
    try:
        res = module.run_protocol(inst.A, inst.y, cfg)
    finally:
        module.make_box = real
    return res, rec["box"].rng.getstate()


@pytest.fixture(scope="module")
def gold_runs():
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=1)
    return inst, _gold_run(rproto, RQuantSpec, inst), \
        _gold_run(protocol, QuantSpec, inst, device="cpu")


@pytest.mark.parametrize("cards", [2, 3])
def test_split_gold_run_equals_unsplit_and_reference(split, gold_runs,
                                                     cards):
    inst, (ref, ref_rng), (whole, whole_rng) = gold_runs
    assert whole.history.tobytes() == ref.history.tobytes()
    bodies = split(cards)
    got, rng = _gold_run(protocol, QuantSpec, inst, device="cpu")
    assert bodies and all(b % (N // K) == 0 or b * cards % (N // K) == 0
                          for b in bodies)
    assert min(bodies) == N // K // cards      # a round's enc/dec chunks
    assert got.history.tobytes() == whole.history.tobytes()
    assert np.array_equal(got.x, ref.x)
    assert rng == whole_rng == ref_rng
    assert report_core(got.stats) == report_core(whole.stats) \
        == rreport_core(ref.stats)


@pytest.mark.parametrize("L", [1, 8, 64, 128])
def test_fft_mul_ref_equals_reference(L):
    rng = np.random.default_rng(L)
    a8 = rng.integers(0, 256, (4, 2 * L), dtype=np.int32)
    b8 = rng.integers(0, 256, (4, 2 * L), dtype=np.int32)

    def ints(limbs, bits):
        return [sum(int(v) << (bits * i) for i, v in enumerate(row))
                for row in np.asarray(limbs)]
    want = ints(rref.fft_mul_ref(a8, b8), 8)
    a16 = torch.as_tensor(bi.from_ints(ints(a8, 8), L))
    b16 = torch.as_tensor(bi.from_ints(ints(b8, 8), L))
    got = ref.fft_mul_ref(a16, b16)
    assert got.shape == (4, 2 * L) and got.dtype == torch.int32
    assert bi.to_ints(got) == want == [x * y for x, y in
                                       zip(ints(a8, 8), ints(b8, 8))]


def test_dryrun_cells_name_their_torch_release():
    with mesh.fake_group(4):
        m = mesh.make_mesh((2, 2), ("data", "model"), "cpu")
        rep = {}
        e = dryrun.run_cell("xlstm_125m", "long_500k", m, report=rep)
    assert e["status"] == "ok" and e["torch"] == torch.__version__


def test_rerun_cells_merges_a_cell(tmp_path, capsys):
    path = tmp_path / "dryrun.json"
    kept = {"status": "ok", "torch": torch.__version__, "kind": "train"}
    path.write_text(json.dumps({"yi_9b/train_4k/16x16": kept,
                                "yi_9b/long_500k/16x16": {
                                    "status": "skipped", "reason": "r"}}))
    patch = _rerun_cells.main(["--report", str(path), "--device", "cpu",
                               "--cells", "xlstm_125m/long_500k"])
    assert list(patch) == ["xlstm_125m/long_500k/16x16"]
    rep = json.loads(path.read_text())
    assert rep["yi_9b/train_4k/16x16"] == kept
    assert rep["yi_9b/long_500k/16x16"]["status"] == "skipped"
    new = rep["xlstm_125m/long_500k/16x16"]
    assert new["status"] == "ok" and new["torch"] == torch.__version__
    assert new["n_devices"] == 256
    assert f"patched 1 cells -> {path}" in capsys.readouterr().out


@pytest.mark.parametrize("release", ["2.11.0+cu128", None])
def test_rerun_cells_refuses_another_release(tmp_path, release):
    path = tmp_path / "dryrun.json"
    cell = {"status": "ok", "kind": "train"}
    if release:
        cell["torch"] = release
    path.write_text(json.dumps({"yi_9b/train_4k/16x16": cell}))
    with pytest.raises(SystemExit, match="not produced by torch"):
        _rerun_cells.main(["--report", str(path), "--device", "cpu",
                           "--cells", "xlstm_125m/long_500k"])
    assert json.loads(path.read_text()) == {"yi_9b/train_4k/16x16": cell}


@pytest.mark.parametrize("flag", ["--shardy", "--scan"])
def test_probe_mem_refuses_xla_flags(flag):
    with pytest.raises(SystemExit, match="the port has none"):
        _probe_mem.main(["--device", "cpu", flag])


def test_probe_mem_prints_the_result_line(capsys):
    res = _probe_mem.main(["--arch", "xlstm_125m", "--batch", "16",
                           "--seq", "16", "--remat", "--constraint",
                           "seq", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("RESULT arch=xlstm_125m constraint=seq "
                           "shardy=False scan=False remat=True peak=")
    for field in ("peak=", "temp=", "args=", "run=", "flops="):
        assert field in line
    assert res["peak"] >= res["args"] > 0 and res["flops"] > 0
