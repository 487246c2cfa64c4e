"""The quorum step's device spans.

``obs/trace.py``'s ``device_span`` marks the step's layer boundaries
(``mochi.quorum_step``, ``mochi.dispatch``, ``mochi.tally``, ``mochi.pin``,
``mochi.readback``) for a ``torch.profiler`` session and is one shared no-op
outside one.  On the CPU: the spans a one-slice CPU mesh's step exports and
how they nest, a slice cut into parts opening one ``mochi.dispatch`` a
part, that no span is built with no profiler running, the private
flag the gate reads, a worker thread's spans, and that the tracing module
imports without torch.  On a card (``python -m pytest --noconftest -m cuda
tests/test_torch_step_spans.py``): one ``mochi.pin`` span around each
group of ``pin_memory()`` calls, in the verify launch and in the tally.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from mochi_tpu_torch.crypto import batch_verify as BV
from mochi_tpu_torch.crypto import keys
from mochi_tpu_torch.obs import trace as T
from mochi_tpu_torch.parallel import make_mesh, make_quorum_step
from mochi_tpu_torch.verifier.spi import VerifyItem

LANES = 8
GROUPS = 3
THRESHOLD = 2
SPANS = (T.SPAN_QUORUM_STEP, T.SPAN_DISPATCH, T.SPAN_TALLY, T.SPAN_PIN, T.SPAN_READBACK)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions at a few lanes gain nothing from threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _signed(i):
    """(public key, message, signature) of signer i."""
    kp = keys.keypair_from_seed(bytes([i + 40] * 32))
    msg = b"step spans %d" % i
    return kp.public_key, msg, kp.sign(msg)


@pytest.fixture(scope="module")
def batch():
    """``prepare_packed``'s seven arrays of LANES signatures (lane 5 forged)
    and their quorum slots."""
    items = []
    for i in range(LANES):
        pub, msg, sig = _signed(i)
        if i == 5:
            sig = bytes([sig[0] ^ 0xFF]) + sig[1:]
        items.append(VerifyItem(pub, msg, sig))
    return (*BV.prepare_packed(items), np.arange(LANES, dtype=np.int32) % GROUPS)


def _profiled_spans(fn, tmp_path, activities=(torch.profiler.ProfilerActivity.CPU,)):
    """Run ``fn`` under a torch profiler session; returns its result and the
    exported trace's ``mochi.*`` spans on the host (on a card the profiler
    also draws each over the device's operations, as ``gpu_user_annotation``)."""
    with torch.profiler.profile(activities=list(activities)) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") in SPANS]
    assert {e["cat"] for e in spans} <= {"user_annotation", "gpu_user_annotation"}
    return out, [e for e in spans if e["cat"] == "user_annotation"]


def _nest(spans, outer_name):
    """The spans of ``outer_name``, each with the spans inside it."""
    outers = [e for e in spans if e["name"] == outer_name]
    return [(o, [e for e in spans if e is not o and o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"] + 1e-2])
            for o in outers]


def _same(a, b):
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_cpu_step_exports_its_spans_nested_on_one_thread(batch, tmp_path):
    step = make_quorum_step(make_mesh(["cpu"]), GROUPS)
    out, spans = _profiled_spans(lambda: step(*batch, THRESHOLD), tmp_path)
    [(outer, inner)] = _nest(spans, T.SPAN_QUORUM_STEP)
    assert sorted(e["name"] for e in inner) == sorted([T.SPAN_DISPATCH, T.SPAN_TALLY] + [T.SPAN_READBACK] * 2)
    assert len(inner) == len(spans) - 1  # every other span lies inside the step's
    assert {(e["pid"], e["tid"]) for e in spans} == {(outer["pid"], outer["tid"])}
    assert not any(e["name"] == T.SPAN_PIN for e in spans)  # the CPU path pins nothing
    bitmap, counts, committed = out
    assert bitmap.tolist() == [i != 5 for i in range(LANES)]
    assert counts.tolist() == [3, 3, 1] and committed.tolist() == [True, True, False]


def test_cpu_step_cut_into_parts_opens_a_dispatch_span_a_part(batch, tmp_path, monkeypatch):
    """With ``MAX_LAUNCH`` patched to 2 the step's one slice of 8 lanes is
    launched in 4 parts: one ``mochi.dispatch`` a part, every one inside
    the step's ``mochi.quorum_step``, and the step's outputs unchanged."""
    step = make_quorum_step(make_mesh(["cpu"]), GROUPS)
    want = step(*batch, THRESHOLD)
    monkeypatch.setattr(BV, "MAX_LAUNCH", 2)
    out, spans = _profiled_spans(lambda: step(*batch, THRESHOLD), tmp_path)
    [(outer, inner)] = _nest(spans, T.SPAN_QUORUM_STEP)
    assert sorted(e["name"] for e in inner) == sorted([T.SPAN_DISPATCH] * 4 + [T.SPAN_TALLY] + [T.SPAN_READBACK] * 2)
    assert len(inner) == len(spans) - 1
    dispatches = sorted((e["ts"], e["ts"] + e["dur"]) for e in inner if e["name"] == T.SPAN_DISPATCH)
    assert all(a[1] <= b[0] + 1e-2 for a, b in zip(dispatches, dispatches[1:]))  # in turn, not nested
    _same(out, want)


def test_no_span_is_built_without_a_profiler(batch, tmp_path, monkeypatch):
    step = make_quorum_step(make_mesh(["cpu"]), GROUPS)
    want, spans = _profiled_spans(lambda: step(*batch, THRESHOLD), tmp_path)
    assert spans

    def refuse(*_a, **_k):
        raise AssertionError("a record_function was built with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _same(step(*batch, THRESHOLD), want)


@pytest.mark.parametrize("name", SPANS)
def test_the_gate_follows_the_profiler(name):
    """The gate reads torch's private ``_is_profiler_enabled``: a torch that
    moves it fails here instead of dropping every span."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert T.device_span(name) is T.device_span(name)  # the one shared no-op
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        span = T.device_span(name)
        assert isinstance(span, torch.autograd.profiler.record_function) and span.name == name
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_a_worker_threads_spans_need_profile_all_threads(tmp_path):
    """The verifier service verifies on executor threads: a session opened
    on another thread records their spans with ``profile_all_threads``."""
    from concurrent.futures import ThreadPoolExecutor

    items = [VerifyItem(*_signed(i)) for i in range(4)]
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with ThreadPoolExecutor(1) as pool:
        pool.submit(lambda: None).result()  # the worker exists before the session
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], experimental_config=cfg) as prof:
            verdicts = pool.submit(BV.verify_batch, items, "cpu").result()
    assert verdicts == [True] * 4
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("name") in SPANS and e.get("cat") == "user_annotation"]
    assert sorted(e["name"] for e in spans) == [T.SPAN_DISPATCH, T.SPAN_READBACK]
    assert len({e["tid"] for e in spans}) == 1


def test_the_tracing_module_imports_without_torch():
    code = "import sys, mochi_tpu_torch.obs.trace as t; t.SPAN_PIN; print('torch' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels have no CPU mode")
    return "cuda:0"


@pytest.mark.cuda
def test_card_step_pins_inside_its_launch_and_its_tally(batch, card, tmp_path):
    step = make_quorum_step(make_mesh([card]), GROUPS)
    want = step(*batch, THRESHOLD)  # builds the kernels
    acts = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    out, spans = _profiled_spans(lambda: step(*batch, THRESHOLD), tmp_path, acts)
    _same(out, want)
    [(_, inner)] = _nest(spans, T.SPAN_QUORUM_STEP)
    assert sorted(e["name"] for e in inner) == sorted(
        [T.SPAN_DISPATCH, T.SPAN_TALLY] + [T.SPAN_PIN] * 2 + [T.SPAN_READBACK] * 2)
    # y_a, sign_a, y_r, sign_r, s and h pinned for the verify launch; pre_ok
    # and the slot ids for the tally
    for name in (T.SPAN_DISPATCH, T.SPAN_TALLY):
        [(_, held)] = _nest(spans, name)
        assert [e["name"] for e in held] == [T.SPAN_PIN]
