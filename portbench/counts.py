"""Least work, bytes and time of one kernel launch, by function; and the
model FLOPs of a language model's train step (:func:`lm_train_flops`).

The yardstick of the benchmark's roofline metrics.  A launch is counted by
the *function* it computes (``mulmod``, ``modexp``, ``modexp_fixed``,
``prod_rows``, ``mulmod_rows``, ``modexp_rows``), never by the body that
ran it: the count is the least work that function needs on these inputs,
so a faster body raises the share and a slower one lowers it, while the
yardstick stays where it was.

Work is counted in 32 x 32-bit word products (two 32-bit IMAD results
each: the low and the high word) on k-word operands:

* a product of two k-word integers: k^2 word products, a squaring
  k(k+1)/2 (the distinct pairs, HAC 14.16);
* a Montgomery reduction (REDC): k^2 + k; a Barrett reduction: the upper
  k+1 words of q1*mu and the low k+1 words of q3*m (HAC 14.42);
* a modular product: the product and the cheaper reduction that stands
  alone, which is Barrett (Montgomery needs the operand brought into the
  domain first, a second product and reduction);
* a modular power: the 4-bit-window ladder, one squaring per exponent bit
  and one product per window plus the 14 products of the window table,
  each reduced, with the entry and exit of the cheaper reduction (REDC:
  one product and two reductions; Barrett: one reduction of the base);
* a row product of N factors: N - 1 modular products, each reduced the
  cheaper way (REDC: the domain factor is corrected once per row).

This is a frozen copy of ``chip_smoke.word_products`` and ``bound_ms``
(that script's copy counted the body's own ladder and reduction) rewritten
to count the function's least work.

Bytes are the operands' public layout (radix-2^16 limbs held in int32, so
2k limbs of 4 bytes for a k-word integer): each input read once and the
output written once; a per-row modulus index adds 4 bytes a row.
"""
from __future__ import annotations

#: One NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W limit): 67 TFLOP/s
#: of FP32 is 2 flops x 128 FMA lanes x 132 SMs x 1.98 GHz.  The 32-bit
#: integer multiply-add pipe has 64 lanes per SM on compute capability 9.0
#: (CUDA C++ Programming Guide, arithmetic instruction throughput), a quarter
#: of the FP32 flop rate: 16.75e12 IMAD results a second.
IMAD_PER_S = 67e12 / 4
#: HBM3 bandwidth of the same part (data sheet).
HBM_BYTES_PER_S = 3.35e12

#: the functions a launch may compute; a body name is ``function[...]``
FUNCTIONS = ("mulmod", "mulmod_rows", "modexp", "modexp_rows",
             "modexp_fixed", "prod_rows")


def function_of(body: str) -> str:
    """The function a kernel body computes: its name before ``[``."""
    return body.split("[")[0]


def product(k: int, square: bool = False) -> int:
    return k * (k + 1) // 2 if square else k * k


def redc(k: int) -> int:
    return k * k + k


def barrett(k: int) -> int:
    return (k + 1) ** 2 - k * (k - 1) // 2 + k + k * (k + 1) // 2


def mulmod_products(k: int) -> int:
    """One modular product standing alone."""
    return min(product(k) + barrett(k), 2 * (product(k) + redc(k)))


def ladder_products(k: int, exp_bits: int) -> int:
    """One modular power with an ``exp_bits``-bit exponent."""
    squares, others = exp_bits, exp_bits // 4 + 14

    def ladder(red):
        return squares * (product(k, True) + red) \
            + others * (product(k) + red)
    mont = ladder(redc(k)) + product(k) + 2 * redc(k)
    bar = ladder(barrett(k)) + barrett(k)
    return min(mont, bar)


def tree_products(k: int, factors: int) -> int:
    """One row's product of ``factors`` factors."""
    return (factors - 1) * (product(k) + min(redc(k), barrett(k)))


def launch_work(function: str, B: int, k: int, *, exp_bits: int = 0,
                factors: int = 0) -> tuple[int, int]:
    """``(word products, bytes)`` of one launch of ``function`` over B
    integers of k words (for ``prod_rows``: B rows of ``factors``)."""
    words = 2 * k * 4                          # one integer's limb bytes
    index = 4 * B if function in ("mulmod_rows", "modexp_rows") else 0
    if function in ("mulmod", "mulmod_rows"):
        return B * mulmod_products(k), 3 * B * words + index
    if function in ("modexp", "modexp_rows"):
        exp_bytes = 4 * -(-exp_bits // 16)
        return B * ladder_products(k, exp_bits), \
            B * (2 * words + exp_bytes) + index
    if function == "modexp_fixed":
        return B * ladder_products(k, exp_bits), 2 * B * words
    if function == "prod_rows":
        return B * tree_products(k, factors), B * (factors + 1) * words
    raise ValueError(f"no count for function {function!r}")


def least_seconds(products: int, nbytes: int) -> float:
    """The larger of the IMAD time and the byte time."""
    return max(2 * products / IMAD_PER_S, nbytes / HBM_BYTES_PER_S)


def exponent_bits(function: str, B: int, *, nk: int, key_bits: int,
                  code_bits: int) -> int:
    """Exponent width of one launch from the cell's own inputs.

    ``modexp_fixed`` raises to key-constant powers (r^n, c^lambda reduced
    mod phi(p^2) or phi(q^2)): below 2^key_bits.  A per-element ModExp
    (``modexp``, ``modexp_rows``) whose batch is a whole number of
    nk x nk blocks is an edge's matvec, whose exponents are the Gamma_2
    codes of rho B_k (``code_bits`` wide); any other raises to a key
    exponent (the serving path's enc and dec)."""
    if function == "modexp_fixed":
        return key_bits
    if B % (nk * nk) == 0:
        return code_bits
    return key_bits


def least_seconds_of(shape_launches: dict, *, nk: int, key_bits: int,
                     code_bits: int, functions=FUNCTIONS) -> dict:
    """Least seconds of every launch in ``shape_launches`` (``{(body, B,
    k): launches}``, as ``kernels/build.SHAPE_LAUNCHES`` counts them),
    summed by function, for the functions named in ``functions``."""
    out: dict = {}
    for (body, B, k), n in shape_launches.items():
        fn = function_of(body)
        if fn not in functions or not n:
            continue
        bits = exponent_bits(fn, B, nk=nk, key_bits=key_bits,
                             code_bits=code_bits) \
            if fn.startswith("modexp") else 0
        work, nbytes = launch_work(fn, B, k, exp_bits=bits, factors=nk)
        out[fn] = out.get(fn, 0.0) + n * least_seconds(work, nbytes)
    return out


#: One NVIDIA H100 SXM's dense bf16 tensor-core rate (data sheet, 700 W).
BF16_FLOP_PER_S = 989.4e12


def lm_nonembedding_params(model: dict) -> int:
    """Parameters of a dense decoder other than the embedding table: each
    layer's attention (q, k, v, o), gated MLP (gate, up, down) and two
    norm scales, the final norm and the output head."""
    d, ff = model["d_model"], model["d_ff"]
    hd = model.get("head_dim") or d // model["n_heads"]
    m = model.get("pad_vocab_multiple", 128)
    vocab = -(-model["vocab"] // m) * m
    attn = d * hd * (2 * model["n_heads"] + 2 * model["n_kv"])
    layer = attn + 3 * d * ff + 2 * d
    return model["n_layers"] * layer + d + d * vocab


def lm_train_flops(model: dict, seq: int, tokens: int) -> float:
    """Model FLOPs of training on ``tokens`` tokens in sequences of
    ``seq``: PaLM's count (arXiv:2204.02311, appendix B), 6 N T for the
    weights' products forward and backward and 12 L H hd S T for
    attention's; no recomputation is counted."""
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    return (6 * lm_nonembedding_params(model) * tokens
            + 12 * model["n_layers"] * model["n_heads"] * hd * seq * tokens)
