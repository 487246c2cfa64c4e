"""The port's plain field ops against the JAX package's, as integers.

Both keep the 17 x 15-bit limb layout and the same loose-carry algorithm,
so every result must match limb for limb (tolerance zero: this is exact
integer arithmetic), and its value must match Python integers mod p.
Inputs come from a numpy seed plus boundary values: 0, 1, p - 1, p, p + 1,
2^255 - 1, the RFC 8032 public keys' y, and limbs at the loose maximum.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mochi_tpu.crypto import field as JF
from mochi_tpu_torch.crypto import field as F

P = F.P_INT
RFC_PUBS = [
    "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
    "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
    "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
]


def _values(seed, n=12):
    rng = np.random.default_rng(seed)
    vals = [0, 1, P - 1, P, P + 1, (1 << 255) - 1, F.D_INT, F.SQRT_M1_INT]
    vals += [int.from_bytes(bytes.fromhex(h), "little") & ((1 << 255) - 1) for h in RFC_PUBS]
    vals += [int.from_bytes(rng.bytes(32), "little") & ((1 << 255) - 1) for _ in range(n)]
    return vals


def _limbs(vals, loose_cols=2):
    """(17, B) int32 limbs of ``vals``, plus ``loose_cols`` columns with
    every limb at the loose maximum (the largest input the ops accept)."""
    arr = np.stack([F.int_to_limbs(v) for v in vals], axis=-1)
    loose = np.full((F.NLIMBS, loose_cols), F.LOOSE, np.int32)
    return np.concatenate([arr, loose], axis=1)


def _both(np_limbs):
    return jnp.asarray(np_limbs), torch.from_numpy(np_limbs.astype(np.int64))


def _same(jax_out, torch_out):
    """Assert limb-for-limb equality; return the values as Python ints."""
    j = np.asarray(jax_out).astype(np.int64)
    t = torch_out.numpy()
    np.testing.assert_array_equal(j, t)
    return F.limbs_to_int_batch(t)


def test_constants_and_limb_helpers_match():
    for name in ("NLIMBS", "RADIX", "MASK", "LOOSE", "P_INT", "D_INT", "SQRT_M1_INT",
                 "L_INT", "BX_INT", "BY_INT"):
        assert getattr(F, name) == getattr(JF, name), name
    for v in _values(1):
        assert (F.int_to_limbs(v) == JF.int_to_limbs(v)).all()
        assert F.limbs_to_int(F.int_to_limbs(v)) == v == JF.limbs_to_int(JF.int_to_limbs(v))
    b = bytes.fromhex(RFC_PUBS[0])
    b = b[:31] + bytes([b[31] & 0x7F])
    assert (F.bytes32_to_limbs(b) == JF.bytes32_to_limbs(b)).all()
    with pytest.raises(AssertionError):
        F.int_to_limbs(1 << 255)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "square", "neg", "mul_small2", "mul_small977"])
def test_ops_match_limb_for_limb(op):
    a_np, b_np = _limbs(_values(2)), _limbs(_values(3))
    (ja, ta), (jb, tb) = _both(a_np), _both(b_np)
    ai, bi = F.limbs_to_int_batch(a_np), F.limbs_to_int_batch(b_np)
    if op in ("add", "sub", "mul"):
        got = _same(getattr(JF, op)(ja, jb), getattr(F, op)(ta, tb))
        fn = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "mul": lambda x, y: x * y}[op]
        want = [fn(x, y) for x, y in zip(ai, bi)]
    elif op in ("square", "neg"):
        got = _same(getattr(JF, op)(ja), getattr(F, op)(ta))
        want = [x * x if op == "square" else -x for x in ai]
    else:
        k = int(op[len("mul_small"):])
        got = _same(JF.mul_small(ja, k), F.mul_small(ta, k))
        want = [k * x for x in ai]
    assert [g % P for g in got] == [w % P for w in want]


def test_loose_invariant_holds_over_long_chains():
    a_np, b_np = _limbs(_values(4), 0), _limbs(_values(5), 0)
    ta, tb = torch.from_numpy(a_np.astype(np.int64)), torch.from_numpy(b_np.astype(np.int64))
    ai, bi = F.limbs_to_int_batch(a_np), F.limbs_to_int_batch(b_np)
    acc, acc_i = ta, list(ai)
    for _ in range(20):
        acc = F.mul(F.add(acc, tb), F.sub(acc, ta))
        acc_i = [(x + y) * (x - a) % P for x, y, a in zip(acc_i, bi, ai)]
        assert int(acc.min()) >= 0 and int(acc.max()) <= F.LOOSE
    assert [v % P for v in F.limbs_to_int_batch(acc)] == acc_i


def test_canonical_eq_select_match():
    a_np = _limbs(_values(6))
    ja, ta = _both(a_np)
    got = _same(JF.canonical(ja), F.canonical(ta))
    assert got == [v % P for v in F.limbs_to_int_batch(a_np)]
    b_np = _limbs([(v + P) % (1 << 255) if v < (1 << 255) - P else v for v in _values(6)])
    jb, tb = _both(b_np)
    np.testing.assert_array_equal(np.asarray(JF.eq(ja, jb)), F.eq(ta, tb).numpy())
    cond = np.arange(a_np.shape[1]) % 2 == 0
    _same(JF.select(jnp.asarray(cond), ja, jb), F.select(torch.from_numpy(cond), ta, tb))


def test_pow_p58_matches():
    vals = _values(7, n=3)
    a_np = _limbs(vals, 1)
    ja, ta = _both(a_np)
    ai = F.limbs_to_int_batch(a_np)
    got = _same(JF.pow_p58(ja), F.pow_p58(ta))
    assert [g % P for g in got] == [pow(x % P, (P - 5) // 8, P) for x in ai]


# ------------------------------------------------------- the mxu multiply


def _mxu_operands(case):
    rng = np.random.default_rng(8)
    if case == "random":
        return _limbs(_values(9), 0), _limbs(_values(10), 0)
    if case == "loose":  # every limb at the limb maximum, beside random loose limbs
        a = rng.integers(0, F.LOOSE + 1, (F.NLIMBS, 6)).astype(np.int32)
        b = rng.integers(0, F.LOOSE + 1, (F.NLIMBS, 6)).astype(np.int32)
        a[:, :3] = F.LOOSE
        b[:, 1:4] = F.LOOSE
        return a, b
    z = np.zeros((F.NLIMBS, 3), np.int32)
    return z, _limbs([0, 1, P - 1], 0)


@pytest.mark.parametrize("case", ["random", "loose", "zeros"])
def test_mul_mxu_matches_the_reference_and_the_schoolbook(case):
    """The plain ``_mul_mxu`` against the reference's, called unjitted on
    JAX's CPU backend (its float32 matmul at precision=HIGHEST), and against
    the port's schoolbook multiply: limb for limb, tolerance zero."""
    a_np, b_np = _mxu_operands(case)
    (ja, ta), (jb, tb) = _both(a_np), _both(b_np)
    got = _same(JF._mul_mxu(ja, jb), F._mul_mxu(ta, tb))
    np.testing.assert_array_equal(F._mul_mxu(ta, tb).numpy(), F.mul(ta, tb).numpy())
    ai, bi = F.limbs_to_int_batch(a_np), F.limbs_to_int_batch(b_np)
    assert [g % P for g in got] == [x * y % P for x, y in zip(ai, bi)]
    out = F._mul_mxu(ta, tb)
    assert int(out.min()) >= 0 and int(out.max()) <= F.LOOSE


def test_mxu_matrix_equals_the_reference():
    mine, ref = F._build_mxu_matrix(), JF._build_mxu_matrix()
    assert mine.shape == ref.shape == (34, 578)
    np.testing.assert_array_equal(mine, ref)
    assert F.available_skews() == JF.available_skews()


@pytest.mark.parametrize("rank", [2, 3])
def test_mul_and_square_under_mxu_match_the_reference(rank, monkeypatch):
    """With ``SKEW_IMPL = "mxu"`` in both packages, rank-2 multiplies and
    squarings take ``_mul_mxu`` and other ranks the schoolbook, as the
    reference dispatches; the limbs equal the reference's either way."""
    monkeypatch.setattr(JF, "SKEW_IMPL", "mxu")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(a.dim()) or real(a, b))
    a_np, b_np = _limbs(_values(11), 1), _limbs(_values(12), 1)
    if rank == 3:
        a_np, b_np = a_np.reshape(F.NLIMBS, 2, -1), b_np.reshape(F.NLIMBS, 2, -1)
    (ja, ta), (jb, tb) = _both(a_np), _both(b_np)
    _same(JF.mul(ja, jb), F.mul(ta, tb))
    _same(JF.square(ja), F.square(ta))
    _same(JF.pow_p58(ja), F.pow_p58(ta))
    assert (used and set(used) == {2}) if rank == 2 else not used


@pytest.mark.parametrize("value", [None, "mxu", "shift", "bogus"])
def test_skew_switch_is_read_as_the_reference_reads_it(value):
    """``MOCHI_SKEW_IMPL`` read at import, in a fresh process: the default
    is ``pad``, both packages hold the same value, and only ``mxu`` sends a
    rank-2 multiply or squaring through ``_mul_mxu`` (an unknown value takes
    the schoolbook, as the reference's ``_skew_cols`` falls back to pad)."""
    import os
    import subprocess
    import sys

    code = (
        "from mochi_tpu_torch.crypto import field as F\n"
        "from mochi_tpu.crypto import field as JF\n"
        "used = []\n"
        "real = F._mul_mxu\n"
        "F._mul_mxu = lambda a, b: used.append(1) or real(a, b)\n"
        "x = F.zeros((3,)) + 5\n"
        "F.mul(x, F.square(x))\n"
        "print(F.SKEW_IMPL, JF.SKEW_IMPL, len(used))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "MOCHI_SKEW_IMPL"}
    env["JAX_PLATFORMS"] = "cpu"
    if value is not None:
        env["MOCHI_SKEW_IMPL"] = value
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    want = value or "pad"
    assert proc.stdout.split() == [want, want, "2" if want == "mxu" else "0"]
