"""The 3xTF32 split of the port's f32 tensor-core products, on the CPU.

``probpose_code_torch/csrc/tc_tiles.cuh:tf32_rna`` rounds an f32 to TF32 by
two integer operations on its bits: add half a TF32 ulp, clear the low 13
bits. The kernels of K1 and K4 split each f32 operand x into
hi = tf32_rna(x) and lo = tf32_rna(x - hi) and take a product as
lo.hi + hi.lo + hi.hi on the tensor cores. These tests read the two
constants from the source and hold, on seeded numpy inputs:

- hi has its low 13 bits zero;
- the rounding is to nearest with ties away from zero, as
  cvt.rna.tf32.f32 rounds (against a rounding computed in float64);
- |x - hi - lo| <= 2^-22 |x| for normal x; subnormals to within half the
  TF32 spacing there (2^-137), +-0 exactly, infinities kept by hi;
- a numpy model of the kernels' products (the three TF32 products of each
  8-deep step, the f32 accumulator truncated toward zero after each, as the
  tensor cores accumulate) keeps a K = 3072 product, K1's fc2 at ViT-B,
  under K1's f32 bar (relative error 1e-4); it lands near 3e-5.
"""

import re
from pathlib import Path

import numpy as np
import pytest

SOURCE = Path(__file__).resolve().parents[1] / "probpose_code_torch" / "csrc" / "tc_tiles.cuh"
K1_F32_REL = 1e-4  # chip_smoke.py's K1 f32 bar


def _constants():
    m = re.search(r"tf32_rna\(float x\) \{ return \(__float_as_uint\(x\) \+ (0x[0-9a-f]+)u\) & (0x[0-9a-f]+)u; \}",
                  SOURCE.read_text())
    assert m, "tf32_rna's formula not found in tc_tiles.cuh"
    return int(m.group(1), 16), int(m.group(2), 16)


ADD, MASK = _constants()


def rna(x: np.ndarray) -> np.ndarray:
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + ADD) & MASK).astype(np.uint32).view(np.float32)


def split(x: np.ndarray):
    hi = rna(x)
    with np.errstate(invalid="ignore"):
        return hi, rna(x - hi)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    normal = (rng.randn(4000) * 10.0 ** rng.uniform(-30, 30, 4000)).astype(np.float32)
    subnormal = (rng.uniform(-1, 1, 1000) * 2.0 ** -126).astype(np.float32)
    return normal, subnormal


def test_constants_are_half_a_tf32_ulp_and_its_mask():
    assert ADD == 1 << 12 and MASK == (0xFFFFFFFF << 13) & 0xFFFFFFFF


def test_hi_has_its_low_13_bits_zero():
    normal, subnormal = _inputs(0)
    for x in (normal, subnormal, np.float32([0.0, -0.0, np.inf, -np.inf])):
        hi, lo = split(x)
        assert not (hi.view(np.uint32) & 0x1FFF).any()
        assert not (lo[np.isfinite(lo)].view(np.uint32) & 0x1FFF).any()


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """Round to 10 explicit mantissa bits, to nearest, ties away from zero,
    in float64: the spacing is 2^(e - 10) with e the binade's exponent (at
    least -126, where f32 turns subnormal)."""
    m = np.abs(x.astype(np.float64))
    e = np.maximum(np.floor(np.log2(np.where(m > 0, m, 1.0))), -126.0)
    ulp = 2.0 ** (e - 10)
    return (np.sign(x) * np.floor(m / ulp + 0.5) * ulp).astype(np.float32)


def test_rounds_to_nearest_with_ties_away():
    normal, subnormal = _inputs(1)
    for x in (normal, subnormal):
        np.testing.assert_array_equal(rna(x), _rna_reference(x))
    # exact ties (low 13 bits 0x1000) go away from zero; just below them, toward
    rng = np.random.RandomState(2)
    base = (rng.randint(0x00800000, 0x7F000000, 1000, dtype=np.int64) & ~0x1FFF).astype(np.uint32)
    for low, away in ((0x1000, True), (0x0FFF, False), (0x1001, True)):
        for sign in (0, 0x80000000):
            x = (base | low | sign).astype(np.uint32).view(np.float32)
            hi = rna(x)
            assert ((np.abs(hi) > np.abs(x)) == away).all()
            np.testing.assert_array_equal(hi, _rna_reference(x))


def test_split_error_bound():
    normal, subnormal = _inputs(3)
    normal = normal[np.abs(normal) < 1e37]  # hi of the largest floats rounds past the range
    hi, lo = split(normal)
    err = np.abs(normal.astype(np.float64) - hi - lo)
    assert (err <= 2.0 ** -22 * np.abs(normal.astype(np.float64))).all()
    hi, lo = split(subnormal)
    assert (np.abs(subnormal.astype(np.float64) - hi - lo) <= 2.0 ** -137).all()
    hi, lo = split(np.float32([0.0, -0.0]))
    assert (hi == 0).all() and (lo == 0).all()
    hi, _ = split(np.float32([np.inf, -np.inf]))
    np.testing.assert_array_equal(hi, np.float32([np.inf, -np.inf]))


def _toward_zero(x64: np.ndarray) -> np.ndarray:
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


@pytest.mark.parametrize("K", [768, 3072])
def test_3xtf32_product_with_truncating_accumulation_keeps_k1s_bar(K):
    rng = np.random.RandomState(K)
    # fc2 at ViT-B reads the GELU's output (K = 3072); qkv, proj, fc1 a LayerNorm's (K = 768)
    a = rng.randn(32, K).astype(np.float32)
    if K == 3072:
        a = np.maximum(a * 0.5, -0.17).astype(np.float32)
    b = (rng.randn(K, 32) * 0.08).astype(np.float32)
    ah, al = split(a)
    bh, bl = split(b)
    acc = np.zeros((32, 32), np.float32)
    for k0 in range(0, K, 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            step = x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(np.float64)
            acc = _toward_zero(acc.astype(np.float64) + step)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rel = np.abs(acc - ref).max() / np.abs(ref).max()
    assert rel < K1_F32_REL / 2
