"""The comb path of the port against the JAX package's.

Host tables and the registry are held byte for byte against
``mochi_tpu.crypto.comb``; the plain PyTorch comb against the reference's
jitted comb program on JAX's CPU backend (exact: both are verdict bitmaps)
and against OpenSSL; the router against the reference's verdicts, with the
``MOCHI_COMB=0`` switch and generation pinning.  The tree accumulation
(``MOCHI_COMB_IMPL=tree``) is held limb for limb against the reference's
``_tree_accumulate`` and by verdict against the chain, OpenSSL and the
reference's programs.  Inputs are made from numpy seeds; every comparison
is exact (integer arithmetic).  The CUDA kernel itself is held against the plain version in
``tests/test_torch_kernel_host.py`` (its g++ build) and on the card.
"""

import asyncio
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mochi_tpu.crypto import batch_verify as JBV
from mochi_tpu.crypto import comb as JC
from mochi_tpu.crypto import field as JF
from mochi_tpu.crypto import keys as jkeys
from mochi_tpu.verifier.spi import VerifyItem as JItem
from mochi_tpu_torch.crypto import batch_verify as BV
from mochi_tpu_torch.crypto import comb as TC
from mochi_tpu_torch.crypto import cuda_comb as CC
from mochi_tpu_torch.crypto import field as F
from mochi_tpu_torch.crypto import keys
from mochi_tpu_torch.verifier.spi import VerifyItem, verifier_stats

P = (1 << 255) - 19


@pytest.fixture(scope="module")
def signers():
    return cs.make_signers(np.random.default_rng(21), 6)


@pytest.fixture(scope="module")
def corpus(signers):
    return cs.make_comb_corpus(22, 96, signers)


@pytest.fixture(scope="module")
def registries(signers):
    jreg, treg = JC.SignerRegistry(), TC.SignerRegistry("cpu")
    for s in signers:
        assert jreg.register(s.pub) == treg.register(s.pub)
    return jreg, treg


def _openssl(items):
    return [jkeys.verify(it.public_key, it.message, it.signature) for it in items]


# ------------------------------------------------------------- host tables


def test_host_tables_are_byte_equal_to_the_reference(signers, registries):
    for s in signers[:3]:
        mine, ref = TC.signer_table(s.pub), JC.signer_table(s.pub)
        assert mine.dtype == ref.dtype == np.int32 and mine.shape == (64, 9, 51)
        assert mine.tobytes() == ref.tobytes()
    assert TC._b_comb().tobytes() == JC._b_comb().tobytes()
    jreg, treg = registries
    assert treg.host_table().tobytes() == np.asarray(jreg.device_table()).tobytes()
    assert np.asarray(treg.device_table("cpu", layout="fe17")).tobytes() == np.asarray(jreg.device_table()).tobytes()
    for s in signers:
        assert TC.decompress_host(s.pub) == JC.decompress_host(s.pub)


def test_registry_refuses_what_the_reference_refuses(signers):
    non_point = next(y for y in range(2, 64) if JC.decompress_host(y.to_bytes(32, "little")) is None)
    x0_sign = bytearray((1).to_bytes(32, "little"))
    x0_sign[31] |= 0x80
    bad = [P.to_bytes(32, "little"), non_point.to_bytes(32, "little"), b"\x00" * 31, bytes(x0_sign)]
    treg, jreg = TC.SignerRegistry("cpu"), JC.SignerRegistry()
    for enc in bad:
        assert treg.register(enc) is None and jreg.register(enc) is None
        assert treg.register(enc) is None  # refusals are remembered
    assert len(treg) == 0 and treg.generation == 0
    for i, s in enumerate(signers):
        assert treg.register(s.pub) == i
    assert [treg.register(s.pub) for s in signers] == list(range(len(signers)))
    assert treg.public_keys() == [s.pub for s in signers] and treg.generation == len(signers)


def test_capacity_crosses_8_to_16_and_pinned_tables_keep_their_shape():
    rng = np.random.default_rng(23)
    pubs = [keys.keypair_from_seed(rng.bytes(32)).public_key for _ in range(10)]
    treg, jreg = TC.SignerRegistry("cpu"), JC.SignerRegistry()
    for p in pubs[:8]:
        treg.register(p)
        jreg.register(p)
    pinned = treg.device_table("cpu", gen=8, layout="fe17")
    assert pinned.shape == (8 * 576, 51)
    for p in pubs[8:]:
        treg.register(p)
        jreg.register(p)
    assert treg.device_table("cpu", gen=8, layout="fe17") is pinned  # the pinned generation's table
    grown = treg.device_table("cpu", layout="fe17")
    assert grown.shape == (16 * 576, 51) and grown is not pinned
    assert np.asarray(grown).tobytes() == np.asarray(jreg.device_table()).tobytes()
    assert treg.host_table(gen=8).tobytes() == np.asarray(jreg.device_table(gen=8)).tobytes()
    # the kernel layout holds the same integers
    r25 = CC.to_radix25(treg.host_table())
    assert r25.shape == (16 * 576, 3, 10)
    assert cs.check_table_radix(torch.from_numpy(r25), grown) == 0


# ------------------------------------------------------------------ verdicts


def test_plain_comb_equals_the_reference_comb_program(corpus, registries):
    """The plain PyTorch comb against ``_verify_comb_jit`` on JAX-CPU, raw
    bitmaps before the host prechecks: forged, another signer's key,
    adversarial R, S >= L, and key indices past the table."""
    items, _, _ = corpus
    jreg, treg = registries
    kidx = np.asarray([treg.index_of(it.public_key) for it in items], dtype=np.int32)
    kidx[3], kidx[7], kidx[11] = 9999, -2, treg.generation  # clipped into the table
    _, _, y_r, sign_r, s_b, h_b, _ = JBV.prepare_packed(
        [JItem(it.public_key, it.message, it.signature) for it in items])
    ref = np.asarray(JC._verify_comb_jit(jreg.device_table(), kidx, y_r, sign_r, s_b, h_b))
    prep = BV.prepare_packed(items)
    for a, b in zip((y_r, sign_r, s_b, h_b), (prep[2], prep[3], prep[4], prep[5])):
        assert np.array_equal(a, b)
    mine = TC.verify_comb_prepared(treg.device_table("cpu", layout="fe17"), *CC.from_prepared(kidx, prep, "cpu"))
    assert mine.tolist() == ref.tolist()
    assert ref.any() and not ref.all()


def test_plain_comb_equals_openssl(corpus, registries):
    items, want, kinds = corpus
    _, treg = registries
    prep = BV.prepare_packed(items)
    kidx = np.asarray([treg.index_of(it.public_key) for it in items], dtype=np.int32)
    got = TC.verify_comb_prepared(treg.device_table("cpu", layout="fe17"), *CC.from_prepared(kidx, prep, "cpu"))
    final = np.logical_and(got.numpy(), prep[6]).tolist()
    assert final == want == _openssl(items)
    assert {"valid", "another signer's key", "x=0 sign=1 R", "S >= L (S + L)", "non-point R"} <= set(kinds)


# ------------------------------------------------------------------- routing


def _mixed(signers, rng):
    strangers = [keys.keypair_from_seed(rng.bytes(32)) for _ in range(2)]
    out = []
    for i in range(18):
        msg = rng.bytes(int(rng.integers(0, 60)))
        if i % 3 == 2:
            kp = strangers[i % 2]
            sig = kp.sign(msg if i % 4 else msg + b"?")
            out.append(VerifyItem(kp.public_key, msg, sig))
        else:
            s = signers[i % len(signers)]
            sig = cs.sign_with(s, i % cs.NONCES_PER_SIGNER, msg)
            if i % 5 == 0:
                sig = sig[:33] + bytes([sig[33] ^ 2]) + sig[34:]
            out.append(VerifyItem(s.pub, msg, sig))
    return out


def test_mixed_batch_routes_registered_keys_to_the_comb(signers, registries):
    _, treg = registries
    items = _mixed(signers, np.random.default_rng(24))
    BV.reset_counts()
    assert BV.verify_batch(items, "cpu", registry=treg) == _openssl(items)
    routed = BV.comb_routing_counts()
    assert routed == {"comb_items": 12, "ladder_items": 6, "mixed_batches": 1}
    assert BV.comb_dispatch_count() == 1 and BV.device_dispatch_count() == 2


def test_comb_switch_and_generation_pinning(signers, registries, monkeypatch):
    _, treg = registries
    items = _mixed(signers, np.random.default_rng(25))
    want = _openssl(items)
    # generation pinned at 2: signers 2.. are "registered later" -> general kernel
    BV.reset_counts()
    assert BV.verify_batch(items, "cpu", registry=treg, comb_gen=2) == want
    idx = [treg.index_of(it.public_key) for it in items]
    n_early = sum(1 for k in idx if k is not None and k < 2)
    assert BV.comb_routing_counts()["comb_items"] == n_early > 0
    monkeypatch.setenv("MOCHI_COMB", "0")
    BV.reset_counts()
    assert BV.verify_batch(items, "cpu", registry=treg) == want
    assert BV.comb_routing_counts()["comb_items"] == 0 and BV.comb_dispatch_count() == 0


def test_backend_registration_and_comb_stats(signers):
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier

    async def main():
        v = CudaBatchVerifier(device="cpu", signers=[s.pub for s in signers[:3]])
        try:
            assert v.register_signers([s.pub for s in signers]) is True
            assert v.backend.registered_signers == [s.pub for s in signers]
            items = _mixed(signers, np.random.default_rng(26))
            BV.reset_counts()
            assert await v.verify_batch(items) == _openssl(items)
            st = verifier_stats(v)["comb"]
            assert st["registered_signers"] == len(signers)
            assert st["items_comb_routed_process_total"] == 12
            assert st["items_ladder_routed_process_total"] == 6
            assert st["device_dispatches_process_total"] == 1
        finally:
            await v.close()

    asyncio.run(asyncio.wait_for(main(), 240))


# ---------------------------------------------------------------------- tree


@pytest.mark.parametrize("n_points,lanes_n", [(8, 3), (128, 2), (128, 4)])
def test_tree_accumulate_equals_the_reference_limb_for_limb(n_points, lanes_n):
    """The plain ``_tree_accumulate`` against the reference's, jitted on
    JAX-CPU: seeded rows of the basepoint comb and a signer table, signs
    applied by the reference's own negation, every coordinate of the sum
    equal limb for limb."""
    rng = np.random.default_rng(31 + n_points + lanes_n)
    tables = np.concatenate([JC._b_comb().reshape(-1, 51),
                             JC.signer_table(keys.keypair_from_seed(rng.bytes(32)).public_key).reshape(-1, 51)])
    rows = tables[rng.integers(0, len(tables), n_points * lanes_n)]  # point-major fused axis
    neg = rng.random(n_points * lanes_n) < 0.5
    ypx, ymx, xy2d = (np.ascontiguousarray(rows[:, 17 * k : 17 * k + 17].T) for k in range(3))
    signed = (np.where(neg, ymx, ypx), np.where(neg, ypx, ymx),
              np.where(neg, np.asarray(JF.neg(jnp.asarray(xy2d))), xy2d))
    ref = jax.jit(partial(JC._tree_accumulate, n_points=n_points, lanes_n=lanes_n))(*map(jnp.asarray, signed))
    mine = TC._tree_accumulate(*(torch.from_numpy(c.astype(np.int64)) for c in signed), n_points, lanes_n)
    for r, m in zip(ref, mine):
        assert m.shape == (17, lanes_n)
        assert np.array_equal(np.asarray(r), m.numpy())


def test_plain_tree_equals_the_chain_the_reference_chain_and_openssl(corpus, registries):
    """The plain tree's raw bitmap equals the plain chain's and the
    reference's chain program's on the comb corpus, key indices past the
    table included; ANDed with the host prechecks it is OpenSSL's verdict."""
    items, want, _ = corpus
    jreg, treg = registries
    prep = BV.prepare_packed(items)
    kidx = np.asarray([treg.index_of(it.public_key) for it in items], dtype=np.int32)
    final = TC.verify_comb_prepared(treg.device_table("cpu", layout="fe17"), *CC.from_prepared(kidx, prep, "cpu"), impl="tree")
    assert np.logical_and(final.numpy(), prep[6]).tolist() == want == _openssl(items)
    kidx[3], kidx[7], kidx[11] = 9999, -2, treg.generation  # clipped into the table
    lanes = CC.from_prepared(kidx, prep, "cpu")
    tree = TC.verify_comb_prepared(treg.device_table("cpu", layout="fe17"), *lanes, impl="tree")
    chain = TC.verify_comb_prepared(treg.device_table("cpu", layout="fe17"), *lanes, impl="chain")
    _, _, y_r, sign_r, s_b, h_b, _ = prep
    # the reference's default program (its chain), the compile the chain's
    # own differential above already made
    ref = np.asarray(JC._verify_comb_jit(jreg.device_table(), kidx, y_r, sign_r, s_b, h_b))
    assert tree.tolist() == chain.tolist() == ref.tolist()
    # the CPU wrapper runs the plain version of the impl it is asked for
    assert CC.verify_comb_prepared(treg.device_table("cpu", layout="fe17"), *lanes, impl="tree").tolist() == tree.tolist()
    assert ref.any() and not ref.all()


def test_comb_impl_switch_parsing_and_refusal(monkeypatch, capsys):
    """The switch is read as the reference reads it: ``tree`` runs the tree
    and any other value the chain (said once on stderr), never a refusal."""
    assert TC.COMB_IMPLS == ("chain", "tree")
    assert TC.COMB_IMPL == ("tree" if os.environ.get("MOCHI_COMB_IMPL") == "tree" else "chain")
    monkeypatch.setattr(TC, "_substituted", set())
    for other in ("Tree", "", "mxu", "tree ", "ladder", "mxu"):
        assert TC.check_impl(other) == "chain"
    err = capsys.readouterr().err
    assert err.count("comb accumulation 'mxu' (MOCHI_COMB_IMPL or impl=) runs the chain") == 1
    assert err.count("runs the chain") == 5
    monkeypatch.setattr(TC, "COMB_IMPL", "tree")
    assert TC.check_impl(None) == "tree" and TC.check_impl("chain") == "chain"
    # read at import: "tree" is taken, any other value imports and runs the chain
    env = dict(os.environ, MOCHI_COMB_IMPL="tree")
    proc = subprocess.run([sys.executable, "-c", "from mochi_tpu_torch.crypto import comb; print(comb.COMB_IMPL)"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "tree"
    env["MOCHI_COMB_IMPL"] = "mxu"
    proc = subprocess.run([sys.executable, "-c", "from mochi_tpu_torch.crypto import comb; print(comb.COMB_IMPL)"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "chain"
    assert "comb accumulation 'mxu' (MOCHI_COMB_IMPL or impl=) runs the chain" in proc.stderr


@pytest.mark.parametrize("skew", ["pad", "mxu"])
def test_stats_name_the_multiply_of_each_kernel(signers, monkeypatch, skew):
    """``verifier_stats`` names the multiply the general kernel runs and the
    comb chain's, which both follow ``MOCHI_SKEW_IMPL``, and the tree's,
    which stays ``pad`` under either; verdicts are unchanged under either
    switch."""
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier

    monkeypatch.setattr(F, "SKEW_IMPL", skew)

    async def main():
        v = CudaBatchVerifier(device="cpu", signers=[s.pub for s in signers[:2]])
        try:
            items = _mixed(signers, np.random.default_rng(31))[:6]
            assert await v.verify_batch(items) == _openssl(items)
            chain = verifier_stats(v)
            monkeypatch.setattr(TC, "COMB_IMPL", "tree")
            assert await v.verify_batch(items) == _openssl(items)
            return chain, verifier_stats(v)
        finally:
            await v.close()

    chain, tree = asyncio.run(asyncio.wait_for(main(), 240))
    assert chain["general"] == {"multiply": skew} and chain["comb"]["impl"] == "chain"
    assert chain["comb"]["multiply"] == skew
    assert tree["general"] == {"multiply": skew} and tree["comb"] == dict(tree["comb"], impl="tree", multiply="pad")
    assert CC.multiply_of("chain") == skew and CC.multiply_of("tree") == "pad"


def test_routing_under_the_tree_switch_and_its_stats(signers, monkeypatch):
    """With ``COMB_IMPL`` set to the tree every comb launch runs the tree
    (here its plain version), verdicts unchanged, and the verifier's stats
    name the impl in use."""
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier

    monkeypatch.setattr(TC, "COMB_IMPL", "tree")
    seen = []
    real = TC.verify_comb_prepared
    monkeypatch.setattr(TC, "verify_comb_prepared", lambda *a, impl=None: seen.append(impl) or real(*a, impl=impl))

    async def main():
        v = CudaBatchVerifier(device="cpu", signers=[s.pub for s in signers])
        try:
            items = _mixed(signers, np.random.default_rng(27))
            BV.reset_counts()
            assert await v.verify_batch(items) == _openssl(items)
            st = verifier_stats(v)["comb"]
            assert st["impl"] == "tree" and st["items_comb_routed_process_total"] == 12
        finally:
            await v.close()

    asyncio.run(asyncio.wait_for(main(), 240))
    assert seen and set(seen) == {"tree"}


@pytest.mark.slow
def test_plain_tree_equals_the_reference_tree_program(corpus, registries):
    """The plain tree against ``_verify_comb_jit(..., impl="tree")`` on
    JAX-CPU (a compile-heavy program, slow as the reference's own tree
    test), raw bitmaps with key indices past the table."""
    items, _, _ = corpus
    jreg, treg = registries
    kidx = np.asarray([treg.index_of(it.public_key) for it in items], dtype=np.int32)
    kidx[3], kidx[7], kidx[11] = 9999, -2, treg.generation
    prep = BV.prepare_packed(items)
    _, _, y_r, sign_r, s_b, h_b, _ = prep
    ref = np.asarray(JC._verify_comb_jit(jreg.device_table(), kidx, y_r, sign_r, s_b, h_b, impl="tree"))
    mine = TC.verify_comb_prepared(treg.device_table("cpu", layout="fe17"), *CC.from_prepared(kidx, prep, "cpu"), impl="tree")
    assert mine.tolist() == ref.tolist()
    assert ref.any() and not ref.all()


# ------------------------------------------------ the chain under mxu


def test_plain_chain_under_mxu_calls_mul_mxu_and_equals_pad_and_openssl(corpus, registries, monkeypatch):
    """Under ``MOCHI_SKEW_IMPL=mxu`` the plain chain (the plain version of
    ``comb_mxu.cu``) multiplies through ``_mul_mxu`` and gives the raw
    bitmap of the chain on the schoolbook, key indices past the table
    included; ANDed with the host prechecks it is OpenSSL's verdict.  The
    CPU wrapper runs it for either multiply."""
    items, want, _ = corpus
    _, treg = registries
    prep = BV.prepare_packed(items)
    kidx = np.asarray([treg.index_of(it.public_key) for it in items], dtype=np.int32)
    clipped = kidx.copy()
    clipped[3], clipped[7], clipped[11] = 9999, -2, treg.generation  # clipped into the table
    table = treg.device_table("cpu", layout="fe17")
    lanes, clipped_lanes = CC.from_prepared(kidx, prep, "cpu"), CC.from_prepared(clipped, prep, "cpu")
    pad = [TC.verify_comb_prepared(table, *ln) for ln in (lanes, clipped_lanes)]
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))
    mxu = [TC.verify_comb_prepared(table, *ln) for ln in (lanes, clipped_lanes)]
    assert used and all(torch.equal(m, p) for m, p in zip(mxu, pad))
    assert pad[1].any() and not pad[1].all()
    assert torch.equal(CC.verify_comb_prepared(table, *clipped_lanes, multiply="mxu"), mxu[1])
    assert np.logical_and(mxu[0].numpy(), prep[6]).tolist() == want == _openssl(items)


def test_plain_chain_under_mxu_equals_the_reference_chain_under_mxu(corpus, registries, monkeypatch):
    """The reference's chain program under ``mxu``, traced afresh (its cached
    ``_verify_comb_jit`` would not retrace when the module global flips),
    against the port's plain chain under ``mxu``: raw bitmaps, key indices
    past the table included."""
    items, _, _ = corpus
    jreg, treg = registries
    kidx = np.asarray([treg.index_of(it.public_key) for it in items], dtype=np.int32)
    kidx[3], kidx[7], kidx[11] = 9999, -2, treg.generation
    prep = BV.prepare_packed(items)
    _, _, y_r, sign_r, s_b, h_b, _ = prep
    monkeypatch.setattr(JF, "SKEW_IMPL", "mxu")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    ref = np.asarray(jax.jit(JC.verify_comb_prepared, static_argnames=("impl",))(
        jreg.device_table(), kidx, y_r, sign_r, s_b, h_b, impl="chain"))
    mine = TC.verify_comb_prepared(treg.device_table("cpu", layout="fe17"), *CC.from_prepared(kidx, prep, "cpu"), impl="chain")
    assert mine.tolist() == ref.tolist()
    assert ref.any() and not ref.all()


def test_device_table_keeps_both_layouts_of_one_generation(signers):
    """One generation, two layouts: the kernel-radix table (``radix25``)
    and the 17 x 15 rows (``fe17``), each cached apart, neither replacing
    or freeing the other; the caller must name the layout, and an unknown
    one is refused."""
    reg = TC.SignerRegistry("cpu")
    reg.register_all([s.pub for s in signers[:3]])
    r25 = reg.device_table("cpu", layout="radix25")
    r17 = reg.device_table("cpu", layout="fe17")
    assert r25.shape == (8 * 576, 3, 10) and r17.shape == (8 * 576, 51)
    assert r25.dtype == r17.dtype == torch.int32
    assert np.array_equal(r17.numpy(), reg.host_table())
    assert np.array_equal(r25.numpy(), CC.to_radix25(reg.host_table()))
    assert cs.check_table_radix(r25, r17) == 0
    # each layout is the same cached tensor on every later call, whichever came last
    for _ in range(2):
        assert reg.device_table("cpu", layout="fe17") is r17 and reg.device_table("cpu", layout="radix25") is r25
    with pytest.raises(TypeError):
        reg.device_table("cpu")  # no default: cuda_comb.table_layout decides
    assert reg.device_table("cpu", gen=3, layout="radix25") is r25
    before = (r25.clone(), r17.clone())
    reg.register_all([s.pub for s in signers[3:]])  # a registration rebuilds both; the old stay whole
    new17, new25 = reg.device_table("cpu", layout="fe17"), reg.device_table("cpu", layout="radix25")
    assert new17 is not r17 and new25 is not r25
    assert torch.equal(r25, before[0]) and torch.equal(r17, before[1])
    assert cs.check_table_radix(new25, new17) == 0
    with pytest.raises(ValueError):
        reg.device_table("cpu", layout="radix17")


def test_routing_pins_the_layout_of_the_switches_it_read(signers, monkeypatch):
    """A batch reads (impl, multiply) once, where it pins its table: the
    layout it asks the registry for and the (impl, multiply) it passes to
    the wrapper agree with the switches at that moment, even when
    ``MOCHI_SKEW_IMPL`` flips between batches or right after the table is
    pinned; verdicts are unchanged throughout.  On a card that pair picks
    the kernel and its table's layout (checked below); on the CPU the plain
    chain's multiplies follow ``field.SKEW_IMPL`` at call time, and its
    bitmap is the same under either."""
    reg = TC.SignerRegistry("cpu")
    reg.register_all([s.pub for s in signers])
    items = _mixed(signers, np.random.default_rng(33))
    want = _openssl(items)
    pinned, launched = [], []
    real_table, real_launch = reg.device_table, CC.verify_comb_prepared

    def device_table(device=None, gen=None, layout=None):
        pinned.append((torch.device(device).type, layout))
        if flip_after_pin:
            F.SKEW_IMPL = "pad" if F.SKEW_IMPL == "mxu" else "mxu"
        return real_table(device, gen, layout=layout)

    monkeypatch.setattr(reg, "device_table", device_table)
    monkeypatch.setattr(CC, "verify_comb_prepared",
                        lambda *a, impl=None, multiply=None: launched.append((impl, multiply)) or real_launch(
                            *a, impl=impl, multiply=multiply))
    monkeypatch.setattr(F, "SKEW_IMPL", "pad")
    flip_after_pin = False
    assert BV.verify_batch(items, "cpu", registry=reg) == want
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")  # between batches
    assert BV.verify_batch(items, "cpu", registry=reg) == want
    flip_after_pin = True  # the switch flips once the table is pinned: the batch passes on what it read
    assert BV.verify_batch(items, "cpu", registry=reg) == want
    assert F.SKEW_IMPL == "pad"
    monkeypatch.setattr(TC, "COMB_IMPL", "tree")
    flip_after_pin = False
    assert BV.verify_batch(items, "cpu", registry=reg) == want
    assert launched == [("chain", "pad"), ("chain", "mxu"), ("chain", "mxu"), ("tree", "pad")]
    assert pinned == [("cpu", "fe17")] * 4
    # on a card the same readings pin the kernel's own layout
    assert [CC.table_layout("cuda", *sw) for sw in launched] == ["radix25", "fe17", "fe17", "radix25"]
    assert [CC.kernel_of(*sw) for sw in launched] == ["chain", "chain_mxu", "chain_mxu", "tree"]
    assert CC.kernel_of("tree", "mxu") == "tree" and CC.table_layout("cuda", "tree", "mxu") == "radix25"


def test_comb_wrapper_refuses_the_layout_its_kernel_does_not_read(signers):
    """The wrapper checks the table's layout before anything runs: a
    kernel-radix table where the 17 x 15 rows are read (the CPU's plain
    version), an unknown multiply."""
    reg = TC.SignerRegistry("cpu")
    reg.register_all([s.pub for s in signers[:2]])
    items = _mixed(signers[:2], np.random.default_rng(34))[:3]
    lanes = CC.from_prepared(np.zeros(3, dtype=np.int32), BV.prepare_packed(items), "cpu")
    with pytest.raises(ValueError, match="fe17 layout"):
        CC.verify_comb_prepared(reg.device_table("cpu", layout="radix25"), *lanes)
    with pytest.raises(ValueError, match="multiply"):
        CC.verify_comb_prepared(reg.device_table("cpu", layout="fe17"), *lanes, multiply="shift")
    assert set(CC.launches) == set(CC.launch_logs) == {"chain", "tree", "chain_mxu"}
