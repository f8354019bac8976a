"""repro_torch's host modules vs the JAX reference: the subnormal flush,
the ADMM baselines, the quantization and bigint remainders, and the
runtime's metrics registry.

* The reference runs its float64 elementwise functions as jnp on XLA's
  CPU backend, which flushes subnormal operands and results to zero
  (keeping the sign of zero); the port flushes them by hand.  Every
  listed function is pinned against the reference on inputs that are
  subnormal, that produce subnormals, or that meet a subnormal
  parameter, with zero tolerance and the sign of zero compared (bytes).
* ``centralized_admm``, ``distributed_admm`` (coupled and not) and
  ``dp_admm`` are float64 linear algebra: the inverse and contractions
  round differently from XLA's, so their iterates are held to the
  reference's within ``ADMM_ATOL`` = 1e-10 (absolute, on iterates of
  order 1; the observed gap is below 1e-13).  ``dp_admm`` gets the
  reference's own ``jax.random`` noise.
* ``split_columns``, ``soft_threshold``, the quantizers and the bigint
  ladder are exact: zero tolerance.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admm as radmm
from repro.core import bigint as rbi
from repro.core import quantization as rq
from repro.obs import metrics as rmetrics
from repro_torch.core import admm
from repro_torch.core import bigint as bi
from repro_torch.core import quantization as q
from repro_torch.obs import metrics

torch.set_num_threads(1)

#: fixed absolute tolerance on the ADMM solvers' iterates
ADMM_ATOL = 1e-10

#: float64 values around the subnormal range, both signs
TINY = np.array([5e-324, -5e-324, 1e-310, -1e-310, 2.2e-308, -2.2e-308,
                 0.0, -0.0, 3e-308, -3e-308, 2.5e-308, -2.5e-308, 1.0,
                 -1.0, 1e-300, -7.5])
#: (delta, zmin, zmax): the paper's, a degenerate span whose square
#: underflows, a subnormal range, a subnormal zmin, a tiny delta
SPECS = [(1e6, -8.0, 8.0), (1e15, -16.0, 16.0), (1e6, 0.0, 1e-300),
         (1e6, -1e-309, 1e-309), (1e6, -5e-324, 0.0), (1e-160, 0.0, 1.0),
         (1e6, 0.0, 1e-160)]


def same(a, b) -> bool:
    """Equal dtype, shape and bytes (so -0.0 differs from 0.0)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the subnormal flush
# ---------------------------------------------------------------------------

def test_soft_threshold_flushes_subnormals_like_the_reference():
    """The fault as found: [3e-308, -3e-308] at t = 2.9e-308 gives
    [0.0, -0.0] in the reference, where eager torch keeps +-1e-309."""
    x = np.array([3e-308, -3e-308])
    got = admm.soft_threshold(torch.as_tensor(x), 2.9e-308).numpy()
    assert same(got, np.array([0.0, -0.0]))
    assert same(got, radmm.soft_threshold(jnp.asarray(x), 2.9e-308))


@pytest.mark.parametrize("t", [2.9e-308, 2.6e-308, 1e-310, 0.0, -0.0, 1.0,
                               5e-324])
def test_soft_threshold_matches_reference_bytes(t):
    rng = np.random.default_rng(1)
    x = np.concatenate([TINY, rng.standard_normal(16),
                        rng.standard_normal(8) * 1e-307, [np.nan]])
    got = admm.soft_threshold(torch.as_tensor(x), t).numpy()
    assert same(got, radmm.soft_threshold(jnp.asarray(x), t))


def test_gamma1_degenerate_span_matches_reference():
    """The fault as found: gamma1([5e-324]) under QuantSpec(1e6, 0.0,
    1e-300) is 0 in the reference (the subnormal input flushes, 0/0 is
    NaN, NaN casts to 0), 2^63 - 1 in eager torch."""
    u = np.array([5e-324])
    got = q.gamma1(u, q.QuantSpec(1e6, 0.0, 1e-300))
    assert same(got, np.array([0], dtype=np.int64))
    assert same(got, rq.gamma1(u, rq.QuantSpec(1e6, 0.0, 1e-300)))


@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("fn", ["gamma1", "gamma2", "inv_gamma1",
                                "inv_gamma2"])
def test_quantizers_match_reference_bytes(fn, spec):
    rng = np.random.default_rng(2)
    for u in (TINY, TINY * 1e-8, rng.standard_normal(32) * 10):
        got = getattr(q, fn)(u, q.QuantSpec(*spec))
        want = getattr(rq, fn)(u, rq.QuantSpec(*spec))
        assert same(got, want), (fn, spec, u[:4])


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_dequantize_theorem1_matches_reference_bytes(spec):
    rng = np.random.default_rng(3)
    for R, rows, w in ((np.arange(16) * 1000.0 + TINY, TINY, 1e-310),
                       (TINY, TINY, -5e-324),
                       (rng.integers(0, 1 << 40, 16).astype(np.float64),
                        rng.standard_normal(16), float(rng.standard_normal()))):
        got = q.dequantize_theorem1(R, rows, w, 7, q.QuantSpec(*spec))
        want = rq.dequantize_theorem1(R, rows, w, 7, rq.QuantSpec(*spec))
        assert same(got, want), (spec, R[:3])


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_quantize_tensor_round_trip_matches_reference_bytes(spec):
    rng = np.random.default_rng(4)
    for u in (TINY, TINY * 1e-8, rng.standard_normal(32),
              np.full(5, 2e-310), np.array([1.0, 1.0])):
        qs = q.QuantSpec(*spec)
        codes, lo, hi = q.quantize_tensor(u, qs)
        rcodes, rlo, rhi = rq.quantize_tensor(u, rq.QuantSpec(*spec))
        assert same(codes, rcodes) and same(lo, rlo) and same(hi, rhi)
        assert same(q.dequantize_tensor(codes, lo, hi, qs),
                    rq.dequantize_tensor(rcodes, rlo, rhi,
                                         rq.QuantSpec(*spec)))


@pytest.mark.parametrize("spec", SPECS[:3], ids=str)
def test_chain_matches_reference(spec):
    rng = np.random.default_rng(5)
    u1, u2, u3 = (rng.standard_normal(12) for _ in range(3))
    B = rng.standard_normal((12, 12)) * 0.1
    got = q.chain(u3, B, u1, u2, q.QuantSpec(*spec))
    assert same(got, rq.chain(u3, B, u1, u2, rq.QuantSpec(*spec)))


def test_flush_subnormal_keeps_the_sign_of_zero():
    x = torch.tensor([1e-310, -1e-310, 5e-324, -5e-324, 2.3e-308, np.inf,
                      -np.inf, np.nan], dtype=torch.float64)
    got = q.flush_subnormal(x).numpy()
    assert same(got[:4], np.array([0.0, -0.0, 0.0, -0.0]))
    assert got[4] == 2.3e-308 and np.isinf(got[5]) and np.isnan(got[7])
    assert same(np.float64(q.flush_subnormal(-1e-320)), np.float64(-0.0))
    assert q.flush_subnormal(1.5) == 1.5


# ---------------------------------------------------------------------------
# the ADMM baselines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    return rng.standard_normal((24, 48)), rng.standard_normal(24)


CONFIGS = {"paper": dict(lam=0.05, iters=30),
           "coupled": dict(lam=0.05, iters=30, coupled=True),
           "y_as_printed": dict(lam=0.1, rho=2.0, iters=20, y_scale="paper")}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_centralized_admm_matches_reference(problem, name):
    A, y = problem
    kw = CONFIGS[name]
    rx, rh = radmm.centralized_admm(jnp.asarray(A), jnp.asarray(y),
                                    radmm.ADMMConfig(**kw))
    x, h = admm.centralized_admm(A, y, admm.ADMMConfig(**kw))
    assert h.shape == (kw["iters"], 48) and h.dtype == torch.float64
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=0,
                               atol=ADMM_ATOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=0,
                               atol=ADMM_ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_distributed_admm_matches_reference(problem, name):
    A, y = problem
    kw = CONFIGS[name]
    rx, rh = radmm.distributed_admm(jnp.asarray(A), jnp.asarray(y), 3,
                                    radmm.ADMMConfig(**kw))
    x, h = admm.distributed_admm(A, y, 3, admm.ADMMConfig(**kw))
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=0,
                               atol=ADMM_ATOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=0,
                               atol=ADMM_ATOL)


def test_dp_admm_matches_reference_on_its_noise(problem):
    A, y = problem
    iters, K, sigma = 15, 3, 0.01
    key = jax.random.PRNGKey(3)
    rx, rh = radmm.dp_admm(jnp.asarray(A), jnp.asarray(y), K,
                           radmm.ADMMConfig(lam=0.05, iters=iters), sigma,
                           key)
    noise = np.stack([np.asarray(jax.random.normal(k, (K, 48 // K),
                                                   jnp.float64))
                      for k in jax.random.split(key, iters)])
    x, h = admm.dp_admm(A, y, K, admm.ADMMConfig(lam=0.05, iters=iters),
                        sigma, noise=noise)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=0,
                               atol=ADMM_ATOL)
    # the noise moved the iterates: the noiseless run differs
    _, h0 = admm.distributed_admm(A, y, K, admm.ADMMConfig(lam=0.05,
                                                           iters=iters))
    assert float((h - h0).abs().max()) > 1e-4


def test_dp_admm_draws_from_a_generator_and_checks_noise_shape(problem):
    A, y = problem
    cfg = admm.ADMMConfig(lam=0.05, iters=4)
    runs = [admm.dp_admm(A, y, 3, cfg, 0.1,
                         generator=torch.Generator().manual_seed(7))[1]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="noise of shape"):
        admm.dp_admm(A, y, 3, cfg, 0.1, noise=np.zeros((4, 3, 15)))
    with pytest.raises(ValueError, match="multiple of K"):
        admm.distributed_admm(A[:, :47], y, 3, cfg)


def test_lasso_objective_and_split_columns_match_reference(problem):
    A, y = problem
    x = np.random.default_rng(6).standard_normal(48)
    got = float(admm.lasso_objective(A, y, x, 0.1))
    want = float(radmm.lasso_objective(jnp.asarray(A), jnp.asarray(y),
                                       jnp.asarray(x), 0.1))
    assert abs(got - want) <= 1e-12 * abs(want)
    for K in (1, 3, 5, 7):
        parts, rparts = admm.split_columns(A, K), radmm.split_columns(A, K)
        assert len(parts) == len(rparts) == K
        assert all(same(a, b) for a, b in zip(parts, rparts))


# ---------------------------------------------------------------------------
# bigint remainders (the reference's plain ladder, not a kernel)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [17, 32, 64, 100])
def test_bigint_modexp_and_mod_small_match_reference(bits):
    rng = random.Random(bits)
    m = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    L = bi.n_limbs_for(m)
    xs = [rng.randrange(m) for _ in range(5)] + [0, 1, m - 1]
    es = [rng.getrandbits(32) for _ in range(5)] + [0, 1, 2 ** 32 - 1]
    mu, ml = bi.barrett_mu(m, L), bi.from_int(m, L)
    base, ex = bi.from_ints(xs, L), bi.from_ints(es, 2)
    got = bi.modexp(torch.as_tensor(base), torch.as_tensor(ex),
                    torch.as_tensor(ml), torch.as_tensor(mu)).numpy()
    assert same(got, rbi.modexp(jnp.asarray(base), jnp.asarray(ex),
                                jnp.asarray(ml), jnp.asarray(mu)))
    assert bi.to_ints(got) == [pow(x, e, m) for x, e in zip(xs, es)]
    wide = [rng.getrandbits(32 * L) for _ in range(6)]
    a = bi.from_ints(wide, 2 * L)
    got = bi.mod_small(torch.as_tensor(a), torch.as_tensor(ml),
                       torch.as_tensor(mu)).numpy()
    assert same(got, rbi.mod_small(jnp.asarray(a), jnp.asarray(ml),
                                   jnp.asarray(mu)))
    assert bi.to_ints(got) == [x % m for x in wide]


# ---------------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------------

def test_histogram_and_registry_match_reference():
    regs = (metrics.Registry(), rmetrics.Registry())
    for reg in regs:
        reg.count("launches")
        reg.count("launches", 4)
        reg.gauge("depth", 3)
        for v in (0.5, 2.0, 1.25, 9.0):
            reg.hist("wall_ms").add(v)
        reg.hist("empty")
    assert regs[0].snapshot() == regs[1].snapshot()
    h, rh = metrics.Histogram(), rmetrics.Histogram()
    assert h.summary() == rh.summary() == {"n": 0}
    for v in range(7):
        h.add(v)
        rh.add(v)
    assert len(h) == len(rh) == 7 and h.summary() == rh.summary()
