"""Per-checker tests for mochi_tpu_torch.analysis, driven by good/bad fixture
pairs under tests/analysis_fixtures/ (the bad file of each pair is also the
seeded-regression corpus tests/test_torch_static_analysis.py runs through the
CLI)."""

import os

import pytest

from mochi_tpu_torch.analysis import core

FIXTURES = os.path.join(os.path.dirname(__file__), "analysis_fixtures")


def fixture(name: str) -> str:
    return os.path.join(FIXTURES, name)


def run_rule(rule: str, filename: str) -> core.RunResult:
    # scoped=False: fixtures live under tests/, outside the production path
    # scopes (e.g. trace-safety only looks at crypto/ + parallel/).
    return core.run([fixture(filename)], rules=[rule], scoped=False)


BAD_EXPECTATIONS = [
    ("async-blocking", "async_blocking_bad.py", 4),
    ("cancellation-hygiene", "cancellation_bad.py", 4),
    ("jax-trace-safety", "trace_safety_bad.py", 5),
    ("constant-time", "const_time_bad.py", 4),
    ("protocol-invariants", "invariants_bad.py", 2),
    ("await-races", "await_races_bad.py", 5),
    ("native-const-time", "native_ct_bad.c", 4),
    ("span-lazy-label", "span_lazy_bad.py", 4),
    ("wire-taint", "wire_taint_bad.py", 5),
    ("unbounded-growth", "unbounded_growth_bad.py", 4),
]


@pytest.mark.parametrize("rule,filename,expected", BAD_EXPECTATIONS)
def test_bad_fixture_trips_checker(rule, filename, expected):
    result = run_rule(rule, filename)
    lines = sorted(f.line for f in result.new)
    assert len(result.new) == expected, (
        f"{filename}: expected {expected} findings, got "
        f"{[f.render() for f in result.new]}"
    )
    assert all(f.rule == rule for f in result.new)
    assert len(set(lines)) == expected, "each seeded site flags exactly once"


@pytest.mark.parametrize(
    "rule,filename",
    [
        ("async-blocking", "async_blocking_good.py"),
        ("cancellation-hygiene", "cancellation_good.py"),
        ("jax-trace-safety", "trace_safety_good.py"),
        ("constant-time", "const_time_good.py"),
        ("protocol-invariants", "invariants_good.py"),
        ("await-races", "await_races_good.py"),
        ("native-const-time", "native_ct_good.c"),
        ("span-lazy-label", "span_lazy_good.py"),
        ("wire-taint", "wire_taint_good.py"),
        ("unbounded-growth", "unbounded_growth_good.py"),
    ],
)
def test_good_fixture_is_clean(rule, filename):
    result = run_rule(rule, filename)
    assert result.new == [], [f.render() for f in result.new]


def test_cross_rule_runs_do_not_bleed():
    # The cancellation fixture must not trip e.g. constant-time, and running
    # every rule over a bad fixture still only reports its own rule's sites.
    result = core.run(
        [fixture("cancellation_bad.py")], scoped=False
    )
    assert {f.rule for f in result.new} == {"cancellation-hygiene"}


# ------------------------------------------------------------- suppressions


def test_suppression_same_line_and_line_above():
    result = core.run([fixture("suppression_fixture.py")], scoped=False)
    assert len(result.new) == 1, [f.render() for f in result.new]
    assert len(result.suppressed) == 2
    # the live finding is the `time.sleep` inside live_violation(), the
    # un-commented third coroutine — not either suppressed site
    src_lines = open(fixture("suppression_fixture.py")).read().splitlines()
    live_def = next(
        i for i, ln in enumerate(src_lines, start=1) if "def live_violation" in ln
    )
    assert result.new[0].line > live_def
    assert result.new[0].snippet == "time.sleep(0.1)"
    assert all(s.line < live_def for s in result.suppressed)


def test_suppression_requires_matching_rule(tmp_path):
    src = (
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)  # mochi-lint: disable=constant-time\n"
    )
    p = tmp_path / "wrong_rule.py"
    p.write_text(src)
    result = core.run([str(p)], scoped=False)
    assert len(result.new) == 1  # suppression names a different rule

    p2 = tmp_path / "all_rule.py"
    p2.write_text(src.replace("constant-time", "all"))
    result = core.run([str(p2)], scoped=False)
    assert result.new == [] and len(result.suppressed) == 1


# ----------------------------------------------------------------- baseline


def test_baseline_grandfathers_and_ratchets(tmp_path):
    target = fixture("async_blocking_bad.py")
    first = core.run([target], scoped=False)
    assert len(first.new) == 4

    baseline_path = tmp_path / "baseline.json"
    core.write_baseline(str(baseline_path), first.new)

    second = core.run([target], scoped=False, baseline=str(baseline_path))
    assert second.new == []
    assert len(second.baselined) == 4

    # a NEW violation is still caught even with the old ones baselined
    extra = tmp_path / "extra.py"
    extra.write_text("import time\nasync def g():\n    time.sleep(2)\n")
    third = core.run(
        [target, str(extra)], scoped=False, baseline=str(baseline_path)
    )
    assert len(third.new) == 1 and third.new[0].path.endswith("extra.py")
    assert len(third.baselined) == 4


def test_fingerprint_survives_line_drift(tmp_path):
    a = tmp_path / "a.py"
    a.write_text("import time\nasync def f():\n    time.sleep(1)\n")
    fp1 = core.run([str(a)], scoped=False).new[0].fingerprint
    # prepend unrelated code: the finding moves lines but not content
    a.write_text("import time\nX = 1\nY = 2\nasync def f():\n    time.sleep(1)\n")
    fp2 = core.run([str(a)], scoped=False).new[0].fingerprint
    assert fp1 == fp2


# -------------------------------------------------------------- odds & ends


def test_raise_in_nested_def_does_not_count_as_reraise(tmp_path):
    # A handler whose only `raise` lives inside a nested function never
    # re-raises in the handler itself — it still swallows CancelledError.
    p = tmp_path / "nested_raise.py"
    p.write_text(
        "async def f(ch):\n"
        "    try:\n"
        "        await ch.get()\n"
        "    except BaseException:\n"
        "        def _log():\n"
        "            raise RuntimeError('later')\n"
        "        register(_log)\n"
    )
    result = core.run([str(p)], rules=["cancellation-hygiene"], scoped=False)
    assert len(result.new) == 1, [f.render() for f in result.new]


def test_local_name_collision_not_flagged(tmp_path):
    # A module-local function whose bare name collides with a deny-list
    # pattern's terminal segment (os.wait, crypto.keys.verify, ...) is NOT a
    # blocking call — single-segment names only match single-segment patterns.
    p = tmp_path / "local_names.py"
    p.write_text(
        "def wait(handles):\n    return handles\n"
        "def verify(x):\n    return x\n"
        "async def f():\n    return wait(verify(1))\n"
    )
    result = core.run([str(p)], rules=["async-blocking"], scoped=False)
    assert result.new == [], [f.render() for f in result.new]


def test_fingerprints_stable_across_cwd(tmp_path, monkeypatch):
    # lint.sh scans from the repo root; standing_rules.py passes absolute
    # paths from an arbitrary CWD — fingerprints must agree or a non-empty
    # baseline silently stops matching.
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text("import time\nasync def f():\n    time.sleep(1)\n")

    monkeypatch.chdir(tmp_path)
    fp_rel = core.run(["pkg"], scoped=False).new[0]
    monkeypatch.chdir("/")
    fp_abs = core.run([str(pkg)], scoped=False).new[0]
    assert fp_rel.path == fp_abs.path == "pkg/mod.py"
    assert fp_rel.fingerprint == fp_abs.fingerprint


def test_single_file_scan_keeps_package_path():
    # Scanning one file must behave exactly like the directory scan that
    # contains it: `analysis mochi_tpu_torch/cluster/config.py` once reported a
    # false-positive protocol-invariants finding (basename display dropped
    # the cluster/config.py exemption), and `analysis mochi_tpu_torch/crypto/keys.py`
    # silently skipped the crypto-scoped checkers.
    import mochi_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(mochi_tpu_torch.__file__))
    cfg = os.path.join(pkg_root, "mochi_tpu_torch", "cluster", "config.py")
    result = core.run([cfg], rules=["protocol-invariants"], scoped=True)
    assert result.new == [], [f.render() for f in result.new]
    keys = os.path.join(pkg_root, "mochi_tpu_torch", "crypto", "keys.py")
    (disp,) = [d for d, _ in core.iter_python_files([keys])]
    assert disp == "mochi_tpu_torch/crypto/keys.py"


def test_identical_snippets_get_distinct_fingerprints(tmp_path):
    p = tmp_path / "twice.py"
    p.write_text(
        "import time\n"
        "async def f():\n    time.sleep(1)\n"
        "async def g():\n    time.sleep(1)\n"
    )
    result = core.run([str(p)], scoped=False)
    assert len(result.new) == 2
    fps = {f.fingerprint for f in result.new}
    assert len(fps) == 2, "one baseline entry must not grandfather both sites"


def test_parse_error_is_a_finding(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    result = core.run([str(p)], scoped=False)
    assert len(result.new) == 1 and result.new[0].rule == "parse-error"


def test_unknown_rule_rejected():
    with pytest.raises(ValueError):
        core.run([FIXTURES], rules=["no-such-rule"])


def test_scoping_excludes_fixture_paths():
    # With default scoping, trace-safety ignores files outside crypto/ and
    # parallel/ — the reason fixture tests pass scoped=False.
    result = core.run(
        [fixture("trace_safety_bad.py")], rules=["jax-trace-safety"], scoped=True
    )
    assert result.new == []


# ------------------------------------------------- await-races: tiers & sites


def test_await_races_severity_tiers_and_subrules():
    result = run_rule("await-races", "await_races_bad.py")
    by_kind = {f.message.split("]")[0].lstrip("["): f for f in result.new}
    assert set(by_kind) == {
        "check-then-act", "stale-read", "shared-iter", "tally-authority"
    }
    assert by_kind["check-then-act"].severity == "high"
    assert by_kind["tally-authority"].severity == "high"
    assert by_kind["stale-read"].severity == "medium"
    assert by_kind["shared-iter"].severity == "medium"
    # tier shows in the rendering but NOT in the fingerprint (re-tiering a
    # rule must not invalidate baselines)
    assert "/high" in by_kind["check-then-act"].render()
    from dataclasses import replace

    retiered = replace(by_kind["check-then-act"], severity="advice")
    assert retiered.fingerprint == by_kind["check-then-act"].fingerprint


def test_await_races_constructor_call_does_not_taint_local(tmp_path):
    # Binding from a call that merely TAKES an element read builds a new
    # value — the first dry run flagged `self._new_replica(self.config
    # .servers[k].host)` shapes tree-wide and drowned the real findings.
    p = tmp_path / "ctor.py"
    p.write_text(
        "import asyncio\n"
        "class C:\n"
        "    async def f(self, k):\n"
        "        fresh = self.build(self.servers[k].host)\n"
        "        await asyncio.sleep(0)\n"
        "        return fresh\n"
    )
    result = core.run([str(p)], rules=["await-races"], scoped=False)
    assert result.new == [], [f.render() for f in result.new]


def test_await_races_slice_of_id_not_tracked(tmp_path):
    # self.client_id[:8] slices an immutable id — not an element read
    p = tmp_path / "slice.py"
    p.write_text(
        "import asyncio\n"
        "class C:\n"
        "    async def f(self):\n"
        "        tag = [f'{self.client_id[:8]}-{j}' for j in range(4)]\n"
        "        await asyncio.sleep(0)\n"
        "        return tag\n"
    )
    result = core.run([str(p)], rules=["await-races"], scoped=False)
    assert result.new == [], [f.render() for f in result.new]


def test_await_races_lock_detection_is_word_level(tmp_path):
    """`with self._lock:` clears a check-then-act; `with self.clock():`
    and `with self.blocking_io():` must NOT — the substring "lock" inside
    an unrelated word would silently disable the highest-severity rule
    for the whole block."""
    template = (
        "import asyncio\n"
        "class C:\n"
        "    async def f(self, k):\n"
        "        if k in self.table:\n"
        "            await asyncio.sleep(0)\n"
        "            with {ctx}:\n"
        "                del self.table[k]\n"
    )
    for ctx, cleared in (
        ("self._lock", True),
        ("self.session_locks[k]", True),
        ("self.clock()", False),
        ("self.blocking_io()", False),
    ):
        p = tmp_path / "lockcase.py"
        p.write_text(template.format(ctx=ctx))
        result = core.run([str(p)], rules=["await-races"], scoped=False)
        if cleared:
            assert result.new == [], (ctx, [f.render() for f in result.new])
        else:
            assert any(
                "check-then-act" in f.message for f in result.new
            ), (ctx, [f.render() for f in result.new])


# --------------------------------------------------------- hygiene & native


def test_unused_suppression_is_a_finding(tmp_path):
    p = tmp_path / "stale_supp.py"
    p.write_text(
        "import asyncio\n"
        "# mochi-lint: disable=async-blocking -- nothing here needs this\n"
        "async def f():\n"
        "    await asyncio.sleep(0)\n"
    )
    result = core.run([str(p)], scoped=False, hygiene=True)
    assert len(result.new) == 1
    assert result.new[0].rule == core.HYGIENE_RULE
    assert "unused suppression" in result.new[0].message
    # without hygiene the same tree passes (rule-subset runs must not
    # convict suppressions the skipped checkers could have vindicated)
    assert core.run([str(p)], scoped=False).new == []


def test_stale_baseline_entry_is_a_finding(tmp_path):
    target = tmp_path / "clean.py"
    target.write_text("import asyncio\nasync def f():\n    await asyncio.sleep(0)\n")
    baseline = tmp_path / "baseline.json"
    import json

    disp = core.display_path(str(target))
    baseline.write_text(
        json.dumps({"fingerprints": ["deadbeefdeadbeef"], "paths": [disp]})
    )
    result = core.run(
        [str(target)], scoped=False, baseline=str(baseline), hygiene=True
    )
    assert len(result.new) == 1
    assert result.new[0].rule == core.HYGIENE_RULE
    assert "stale baseline entry deadbeefdeadbeef" in result.new[0].message


def test_stale_baseline_needs_coverage_to_convict(tmp_path):
    """A partial-path run must NOT convict baseline entries it couldn't
    have matched (the entry may belong to an unscanned file — convicting
    it, and the --write-baseline advice in the message, would silently
    amnesty every unscanned file's grandfathered debt).  Coverage comes
    from the ``paths`` record --write-baseline stores; a legacy baseline
    without one never convicts."""
    import json

    a = tmp_path / "a.py"
    b = tmp_path / "b.py"
    for p in (a, b):
        p.write_text("import asyncio\nasync def f():\n    await asyncio.sleep(0)\n")
    baseline = tmp_path / "baseline.json"
    # entry recorded against BOTH files: scanning only b.py is not coverage
    baseline.write_text(
        json.dumps(
            {
                "fingerprints": ["deadbeefdeadbeef"],
                "paths": [core.display_path(str(a)), core.display_path(str(b))],
            }
        )
    )
    partial = core.run(
        [str(b)], scoped=False, baseline=str(baseline), hygiene=True
    )
    assert partial.new == []
    # legacy baseline (no paths record): staleness is undecidable — silent
    baseline.write_text(json.dumps({"fingerprints": ["deadbeefdeadbeef"]}))
    legacy = core.run(
        [str(a), str(b)], scoped=False, baseline=str(baseline), hygiene=True
    )
    assert legacy.new == []


def test_write_baseline_records_scanned_paths(tmp_path):
    target = fixture("async_blocking_bad.py")
    first = core.run([target], scoped=False)
    assert first.new
    baseline_path = tmp_path / "baseline.json"
    core.write_baseline(str(baseline_path), first.new, scanned=first.scanned)
    assert core.load_baseline_paths(str(baseline_path)) == set(first.scanned)
    # the round trip convicts nothing (all entries still match) and a
    # removed finding WOULD convict: full coverage is satisfied
    again = core.run(
        [target], scoped=False, baseline=str(baseline_path), hygiene=True
    )
    assert again.new == [] and len(again.baselined) == len(first.new)


def test_suppression_justification_does_not_bleed_into_rules(tmp_path):
    # `disable=<rule> -- why` must suppress <rule>; the prose after the
    # rule list once bled into the parsed rule names and disabled nothing
    p = tmp_path / "justified.py"
    p.write_text(
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)  # mochi-lint: disable=async-blocking -- justified: fixture\n"
    )
    result = core.run([str(p)], scoped=False, hygiene=True)
    assert result.new == [], [f.render() for f in result.new]
    assert len(result.suppressed) == 1


def test_native_hbatch_sign_path_pinned_clean():
    # The REAL engine is the known-good fixture: ge_mul_base is annotated
    # `mochi-ct: secret(k)` and must scan clean apart from the one reviewed
    # comb-table suppression — which must be load-bearing (hygiene would
    # flag it as unused otherwise).
    import mochi_tpu_torch

    native = os.path.join(
        os.path.dirname(mochi_tpu_torch.__file__), "native", "hbatch.c"
    )
    result = core.run([native], rules=["native-const-time"], scoped=True)
    assert result.new == [], [f.render() for f in result.new]

    full = core.run([native], hygiene=True)
    assert full.new == [], [f.render() for f in full.new]
    assert len(full.suppressed) == 1  # the BCOMB secret-index site


def test_native_ct_compound_assignment_taints(tmp_path):
    """`d |= k[0]` must taint `d` like `d = k[0]` does — accumulate-into
    is THE dominant constant-time C idiom, and missing it silently
    un-flags the secret branch on the accumulator.  Comparisons must not
    false-taint."""
    p = tmp_path / "acc.c"
    p.write_text(
        "/* mochi-ct: secret(k) */\n"
        "static int acc(const unsigned char k[32]) {\n"
        "    int d = 0;\n"
        "    d |= k[0];\n"
        "    if (d) { return 1; }\n"
        "    int clean = 0;\n"
        "    int cmp = (clean == 0);\n"
        "    if (cmp) { return 2; }\n"
        "    return 0;\n"
        "}\n"
    )
    result = core.run([str(p)], rules=["native-const-time"], scoped=False)
    branch = [f for f in result.new if "secret-branch" in f.message]
    assert len(branch) == 1, [f.render() for f in result.new]
    assert branch[0].line == 5  # `if (d)` — not the cmp branch


def test_await_races_mutating_call_kwarg_await_is_boundary(tmp_path):
    """An await inside a KEYWORD argument of a mutating call is a segment
    boundary like any positional-arg await — skipping it corrupted segment
    numbering and silently suppressed every sub-rule downstream."""
    p = tmp_path / "kw.py"
    p.write_text(
        "class C:\n"
        "    async def f(self, k):\n"
        "        v = self.table[k]\n"
        "        self.stats.update(extra=await self.fetch())\n"
        "        return v\n"
    )
    result = core.run([str(p)], rules=["await-races"], scoped=False)
    assert len(result.new) == 1, [f.render() for f in result.new]
    assert "stale" in result.new[0].message
    assert result.new[0].line == 5  # the post-await use of `v`


def test_await_races_augassign_reads_stale_local(tmp_path):
    """`n += 1` LOADS n before the store: a tracked element read used this
    way after an await is exactly the read-modify-write of stale state the
    rule exists for."""
    p = tmp_path / "aug.py"
    p.write_text(
        "import asyncio\n"
        "class C:\n"
        "    async def f(self, k):\n"
        "        n = self.counts[k]\n"
        "        await asyncio.sleep(0)\n"
        "        n += 1\n"
        "        return n\n"
    )
    result = core.run([str(p)], rules=["await-races"], scoped=False)
    assert len(result.new) == 1, [f.render() for f in result.new]
    assert "stale" in result.new[0].message
    assert result.new[0].line == 6  # the augmented load, not the return


def test_native_ct_two_line_header_scanned(tmp_path):
    """A function whose name sits on the line AFTER its return type (the
    GNU/kernel style) must scan like a single-line header — it used to
    bypass the checker entirely."""
    p = tmp_path / "two.c"
    p.write_text(
        "/* mochi-ct: secret(k) */\n"
        "static void\n"
        "two_line(const unsigned char k[32], unsigned char *out) {\n"
        "    if (k[0]) {\n"
        "        out[0] = 1;\n"
        "    }\n"
        "}\n"
    )
    result = core.run([str(p)], rules=["native-const-time"], scoped=False)
    branch = [f for f in result.new if "secret-branch" in f.message]
    assert len(branch) == 1, [f.render() for f in result.new]
    assert branch[0].line == 4


def test_native_hbatch_checker_not_vacuous(tmp_path):
    # Strip the reviewed suppression from the real file: the comb-table
    # lookup must then flag — proving the annotation + taint actually
    # reach the hot site (the pin isn't a scope accident).
    import mochi_tpu_torch

    native = os.path.join(
        os.path.dirname(mochi_tpu_torch.__file__), "native", "hbatch.c"
    )
    src = open(native).read()
    stripped = "\n".join(
        ln for ln in src.splitlines() if "mochi-lint" not in ln
    )
    tree = tmp_path / "native"
    tree.mkdir()
    (tree / "hbatch.c").write_text(stripped)
    result = core.run([str(tree / "hbatch.c")], rules=["native-const-time"], scoped=False)
    assert len(result.new) == 1, [f.render() for f in result.new]
    assert "BCOMB" in result.new[0].snippet
    assert result.new[0].severity == "advice"


# ------------------------------------------- differential: the two packages

ALL_FIXTURES = sorted(
    n for n in os.listdir(FIXTURES) if n.endswith((".py", ".c"))
)


def _finding_rows(result):
    return [
        (f.rule, f.path, f.line, f.col, f.message, f.severity, f.fingerprint)
        for f in sorted(result.new + result.suppressed,
                        key=lambda f: (f.path, f.line, f.col, f.rule))
    ]


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_every_fixture_gives_the_reference_findings(name):
    """The port's pass is the reference's: over each fixture, read in
    place, both packages report the same findings — rule, line, column,
    message, severity and fingerprint — and suppress the same ones."""
    from mochi_tpu.analysis import core as ref_core

    path = fixture(name)
    ported = core.run([path], scoped=False, cache=False)
    reference = ref_core.run([path], scoped=False, cache=False)
    assert _finding_rows(ported) == _finding_rows(reference)
    assert ported.files_scanned == reference.files_scanned == 1


def test_fixture_corpus_is_complete():
    # 10 good/bad pairs, one per checker, plus the suppression fixture
    assert len(ALL_FIXTURES) == 21, ALL_FIXTURES


def test_ellipsis_lowers_as_a_constant_in_both_packages(tmp_path):
    # ``...`` parses as ast.Constant; the port tests ast.Constant alone where
    # the reference also names the deprecated ast.Ellipsis — same findings
    from mochi_tpu.analysis import core as ref_core

    target = tmp_path / "ellipsis.py"
    target.write_text(
        "class R:\n"
        "    def stub(self, frame): ...\n"
        "    def f(self, frame, store):\n"
        "        env = decode_env(frame)\n"
        "        x = ...\n"
        "        store.process_write1(..., x)\n"
        "        return store.process_write1(env if ... else ..., ...)\n"
    )
    ported = core.run([str(target)], rules=["wire-taint"], scoped=False, cache=False)
    reference = ref_core.run([str(target)], rules=["wire-taint"], scoped=False, cache=False)
    assert len(ported.new) == 1 and ported.new[0].line == 7
    assert _finding_rows(ported) == _finding_rows(reference)
