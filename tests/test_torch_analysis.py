"""repro-lint over the port (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

The framework and the three framework-free checkers are copies that
differ only in their imports and package-path literals; every fire/fix
fixture pair of ``tests/test_analysis.py`` for the framework-free rules
gives equal findings through both packages; the torch host-sync rule and
the capture-purity rule each have pairs that fire and pairs that stay
silent (the kernel wrappers' CPU branch both ways); every capture root
resolves, a deleted one is a finding, and a ``.item()`` put into a copy
of ``decode_steps_paged`` is found; the live tree lints clean through
``python -m repro_torch.analysis``, and the reference's
``scripts/analyze.py`` still does over ``src/repro``. All AST: no model
runs here."""
import json
import runpy
import shutil
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import repro.analysis as ra
import repro_torch.analysis as ta
from repro.analysis import checkers as rchk
from repro.analysis import core as rcore
from repro_torch.analysis import checkers as tchk
from repro_torch.analysis import core as tcore
from repro_torch.analysis.checkers import host_sync, purity
from torch_copy_helpers import same_but_imports

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"

# module -> the package-path literals its copy rewrites
COPIES = {
    "cfg.py": (),
    "core.py": ('"repro_torch/"',),
    "checkers/resource.py": ('"repro_torch/serving/"',),
    "checkers/accounting.py": ('"repro_torch/serving/"',
                               '"repro_torch/serving/engine.py"',
                               '"repro_torch/serving/channels.py"'),
    "checkers/config_drift.py": ('"repro_torch/launch/serve.py"',
                                 '"repro_torch/serving/engine.py"'),
}


def _write(root: Path, files: dict) -> Path:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def _port_files(files: dict) -> dict:
    """A reference fixture moved to the port: ``repro/`` paths and
    ``repro.`` imports become ``repro_torch``'s."""
    return {"repro_torch/" + rel[len("repro/"):]:
            src.replace("from repro.", "from repro_torch.")
            for rel, src in files.items()}


# ----------------------------- the copies ------------------------------ #

@pytest.mark.parametrize("name", sorted(COPIES))
def test_copy_differs_only_in_imports_and_literals(name):
    port = (SRC / "repro_torch" / "analysis" / name).read_text()
    ref = (SRC / "repro" / "analysis" / name).read_text()
    assert same_but_imports(port, ref, COPIES[name])
    for lit in COPIES[name]:
        assert lit in port


def test_same_but_imports_refuses_other_edits():
    ref = ('from repro.analysis.core import (Finding,\n'
           '                                 Project)\n'
           'SCOPE = "repro/serving/"\nN = 12\n')
    port = ('from repro_torch.analysis.core import (Finding,\n'
            '                                       Project)\n'
            'SCOPE = "repro_torch/serving/"\nN = 12\n')
    lits = ('"repro_torch/serving/"',)
    assert same_but_imports(port, ref, lits)
    # the literal is not listed, another line changed, another import
    assert not same_but_imports(port, ref)
    assert not same_but_imports(port.replace("N = 12", "N = 13"), ref, lits)
    assert not same_but_imports(port.replace("Project)", "Module)"), ref,
                                lits)
    assert not same_but_imports(
        port.replace('"repro_torch/serving/"', '"repro_torch/launch/"'),
        ref, lits)


def test_exports_match_the_reference():
    assert ta.__all__ == ra.__all__
    assert tchk.__all__ == rchk.__all__
    assert len(tchk.ALL_CHECKERS) == len(rchk.ALL_CHECKERS)
    assert tcore.KNOWN_RULES == rcore.KNOWN_RULES


# ----------- the framework-free rules: equal findings in both ----------- #

_STATS = """
    class ServeStats:
        mystery_total: int = 0

    class Eng:
        def __init__(self):
            self.stats = ServeStats()

        def run(self, trace):
            {write}
            trace.reconcile({reconcile})
"""
_ENGINE_FIX = """
    class ServeEngine:
        def __init__(self, cfg, page_size=16, dead_knob=0):
            self.cfg = cfg
            self.page_size = page_size
"""
_SERVE_FIX = """
    import argparse
    from repro.serving.engine import ServeEngine

    def main():
        ap = argparse.ArgumentParser()
        ap.add_argument("--page-size", type=int, default=16)
        ap.add_argument("--ghost-knob", type=int, default=0)
        args = ap.parse_args()
        return ServeEngine(object(), page_size=args.page_size, bogus=1)
"""
_LEAK = """
    def serve(kv, rids, t0, ok):
        {pragma}
        plan = kv.plan_residency(rids, t0)
        if ok:
            kv.charge_residency(plan)
        {fix}
"""
_SWALLOW = """
    def serve(kv, rids, t0):
        plan = kv.plan_residency(rids, t0)
        try:
            validate(plan)
            kv.charge_residency(plan)
        except RuntimeError:
            {handler}
"""
_POOL = """
    class Pool:
        def admit(self, kv, rid, n):
            kv.reserve_ahead(rid, n)
            self.live = rid
"""
_CLOCKS = {
    "repro/serving/clock.py": """
        import time

        def stamp():
            return time.{fn}()
    """,
    "repro/launch/dryrun.py": """
        import time

        def harness():
            return time.time()
    """,
    "repro/serving/virt.py": """
        import time

        def basis():
            return time.perf_counter()
    """,
}

# name -> (rule, files, fires, a text the findings' messages hold): the
# reference's fixtures, both halves of every pair
_MYSTERY = "mystery_total"
CASES = {
    "resource-all-paths-leak": ("resource-pairing", {
        "repro/serving/loop.py": _LEAK.format(pragma="", fix="")}, True, ""),
    "resource-all-paths-covered": ("resource-pairing", {
        "repro/serving/loop.py": _LEAK.format(
            pragma="", fix="else:\n            kv.charge_residency(plan)")},
        False, ""),
    "resource-handler-swallow": ("resource-pairing", {
        "repro/serving/loop.py": _SWALLOW.format(handler="pass")}, True, ""),
    "resource-handler-charge": ("resource-pairing", {
        "repro/serving/loop.py": _SWALLOW.format(
            handler="kv.charge_residency(plan)")}, False, ""),
    "resource-conduit": ("resource-pairing", {"repro/serving/loop.py": """
        def make_plan(kv, rids, t0):
            return kv.plan_residency(rids, t0)

        def reserve(kv, rid, n):
            r = kv.reserve_ahead(rid, n)
            return r
    """}, False, ""),
    "resource-reach-leak": ("resource-pairing", {
        "repro/serving/pool.py": _POOL}, True, ""),
    "resource-class-owner": ("resource-pairing", {
        "repro/serving/pool.py": _POOL + """
            def drop(self, kv, rid):
                kv.release_reserved(rid)
    """}, False, ""),
    "wall-clock-banned": ("wall-clock", {
        k: v.replace("{fn}", "time") for k, v in _CLOCKS.items()}, True, ""),
    "wall-clock-perf-counter": ("wall-clock", {
        k: v.replace("{fn}", "perf_counter") for k, v in _CLOCKS.items()},
        False, ""),
    "accounting-unwritten": ("accounting", {"repro/serving/engine.py":
        _STATS.format(write="pass", reconcile="")}, True, _MYSTERY),
    "accounting-unreconciled": ("accounting", {"repro/serving/engine.py":
        _STATS.format(write="self.stats.mystery_total += 1",
                      reconcile="")}, True, _MYSTERY),
    "accounting-reconciled": ("accounting", {"repro/serving/engine.py":
        _STATS.format(write="self.stats.mystery_total += 1",
                      reconcile="mystery_total=self.stats.mystery_total")},
        False, _MYSTERY),
    # every EXEMPT entry is stale in a fixture engine
    "accounting-stale-exemption": ("accounting", {"repro/serving/engine.py":
        _STATS.format(write="self.stats.mystery_total += 1",
                      reconcile="mystery_total=self.stats.mystery_total")},
        True, "stale exemption"),
    "channel-vocab-bad": ("channel-vocab", {"repro/serving/tiers.py": """
        GOOD = "ddr->hbs"
        BAD = "ddr->weird"

        def label(src, dst):
            return f"{src}->{dst}"
    """}, True, ""),
    "channel-vocab-good": ("channel-vocab", {"repro/serving/tiers.py": """
        GOOD = "ddr->hbs"
    """}, False, ""),
    "config-drift-fires": ("config-drift", {
        "repro/launch/serve.py": _SERVE_FIX,
        "repro/serving/engine.py": _ENGINE_FIX}, True, ""),
    "config-drift-wired": ("config-drift", {
        "repro/launch/serve.py": _SERVE_FIX.replace(
            '        ap.add_argument("--ghost-knob", type=int, default=0)\n',
            "").replace(", bogus=1", ""),
        "repro/serving/engine.py": _ENGINE_FIX.replace(", dead_knob=0", "")},
        False, ""),
    "pragma-justified": ("pragma", {"repro/serving/loop.py": _LEAK.format(
        pragma="# repro: allow(resource-pairing): fixture suppression",
        fix="")}, False, ""),
    "pragma-unjustified": ("pragma", {"repro/serving/loop.py": _LEAK.format(
        pragma="# repro: allow(resource-pairing)", fix="")}, True, ""),
    "pragma-unknown-rule": ("pragma", {"repro/serving/ok.py": """
        # repro: allow(made-up-rule): whatever
        X = 1
    """}, True, ""),
}


def _findings(pkg, chk, root: Path, rule: str, text: str):
    project = pkg.load_project(root)
    if rule == "pragma":
        # the pragma meta-checks beside the rule a pragma suppresses
        fs = pkg.run_checkers(project, [chk.resource.check])
    else:
        mod = {"resource-pairing": chk.resource,
               "wall-clock": chk.host_sync, "accounting": chk.accounting,
               "channel-vocab": chk.accounting,
               "config-drift": chk.config_drift}[rule]
        fs = [f for f in mod.check(project) if f.rule == rule]
    return sorted((f.rule, f.line, f.qualname) for f in fs
                  if text in f.message)


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_packages_give_equal_findings(case, tmp_path):
    rule, files, fires, text = CASES[case]
    ref = _findings(ra, rchk, _write(tmp_path / "ref", files), rule, text)
    port = _findings(ta, tchk, _write(tmp_path / "port", _port_files(files)),
                     rule, text)
    assert port == ref
    assert bool(port) == fires, port


def test_baseline_workflow_matches_the_reference(tmp_path):
    for pkg, core in (("repro", rcore), ("repro_torch", tcore)):
        f1 = core.Finding("host-sync", f"{pkg}/serving/e.py", 1, "a", "m1")
        f2 = core.Finding("host-sync", f"{pkg}/serving/e.py", 2, "b", "m2")
        assert f1.fingerprint == core.Finding(
            "host-sync", f"{pkg}/serving/e.py", 99, "a", "m1").fingerprint
        bl = tmp_path / f"{pkg}.json"
        core.write_baseline(bl, [f1], justification="fixture")
        baseline = core.load_baseline(bl)
        assert core.apply_baseline([f1, f2], baseline) == ([f2], [])
        new, stale = core.apply_baseline([f2], baseline)
        assert new == [f2] and len(stale) == 1
        bl.write_text(json.dumps({"findings": [
            {"fingerprint": "abc", "rule": "host-sync",
             "justification": " "}]}))
        with pytest.raises(ValueError, match="justification"):
            core.load_baseline(bl)


def test_wall_clock_allows_the_rank_launcher(tmp_path):
    """ranks.py keeps real time (a failure order, a join deadline); a
    serving module may not."""
    clock = """
        import time

        def stamp():
            return time.time(), time.monotonic()
    """
    p = ta.load_project(_write(tmp_path, {
        "repro_torch/launch/ranks.py": clock,
        "repro_torch/launch/serve.py": clock}))
    fs = [f for f in host_sync.check(p) if f.rule == "wall-clock"]
    assert sorted({f.path for f in fs}) == ["repro_torch/launch/serve.py"]
    assert len(fs) == 2


# ------------------------- the torch host-sync rule --------------------- #

_ENGINE = """
    import numpy as np
    import torch
    from repro_torch.models import decode_steps_paged


    def _sync(device):
        torch.cuda.synchronize(device)


    class Engine:
        def __init__(self, stats, device):
            self.stats = stats
            self.device = device

        def _dev(self, a):
            return torch.as_tensor(a, device=self.device)

        def run(self, x, latencies):
            blk = decode_steps_paged(self._dev(x))
            out = {pull}
            {count}
            return out, np.asarray(latencies)
"""
PULLS = {"cpu": "blk.cpu()", "tolist": "blk.tolist()",
         "int": "int(blk[0])", "synchronize": "torch.cuda.synchronize()",
         "asarray": "np.asarray(blk)", "helper": "_sync(self.device)",
         "chained": "torch.cat([blk, blk]).float().cpu().numpy()"}


def _sync_project(tmp_path, pull, count):
    return ta.load_project(_write(tmp_path, {
        "repro_torch/serving/engine.py": _ENGINE.format(pull=pull,
                                                        count=count)}))


@pytest.mark.parametrize("kind", sorted(PULLS))
def test_host_sync_uncounted_pull_fires(kind, tmp_path):
    fs = [f for f in host_sync.check(_sync_project(tmp_path, PULLS[kind],
                                                   "pass"))
          if f.rule == "host-sync"]
    assert len(fs) == 1 and fs[0].qualname == "Engine.run", fs
    assert "host_syncs" in fs[0].message


@pytest.mark.parametrize("kind", sorted(PULLS))
def test_host_sync_adjacent_count_is_silent(kind, tmp_path):
    p = _sync_project(tmp_path, PULLS[kind], "self.stats.host_syncs += 1")
    assert [f for f in host_sync.check(p) if f.rule == "host-sync"] == []
    sites = host_sync.counted_sites(p)
    # the helper's own synchronize answers to its caller
    assert [(s.qualname, s.counted) for s in sites] == [("Engine.run",
                                                         True)]
    line = next(i for i, t in enumerate(
        (tmp_path / "repro_torch/serving/engine.py").read_text()
        .splitlines(), 1) if t.strip().startswith("out = "))
    assert sites[0].line == line


def test_host_sync_host_values_never_flagged(tmp_path):
    """np.asarray / int / .tolist() of host data: no sync."""
    p = ta.load_project(_write(tmp_path, {"repro_torch/serving/eng.py": """
        import numpy as np

        def digest(latencies, blk_np):
            arr = np.asarray(latencies)
            n = int(blk_np[0])
            return float(arr.mean()), arr.tolist(), n, len(blk_np)
    """}))
    assert [f for f in host_sync.check(p) if f.rule == "host-sync"] == []
    assert host_sync.sync_sites(p) == []


def test_sync_class_reads_the_statement(tmp_path):
    p = _sync_project(tmp_path, "blk.cpu()", "pass")
    mod = p.module("repro_torch/serving/engine.py")
    lines = mod.source.splitlines()

    def at(text):
        return next(i for i, t in enumerate(lines, 1) if text in t)
    assert host_sync.sync_class(mod, at("out = blk.cpu()")) == "pull"
    assert host_sync.sync_class(mod, at("torch.as_tensor")) == "upload"
    assert host_sync.sync_class(mod, at("self.stats = stats")) == "other"


# --------------------------- capture purity ----------------------------- #

_ROOT = """
    import numpy as np
    import torch


    def _helper(x):
        return x.sum().item()


    def step(x, n_steps: int, g=None):
        {body}
        return x
"""
ROOT_PAIRS = {
    "sync": ("y = x.sum().item()", "y = x.sum()"),
    "callee-sync": ("y = _helper(x)", "y = x.sum()"),
    "upload": ("y = torch.as_tensor(np.arange(4), device=x.device)",
               "y = torch.arange(4, device=x.device)"),
    "global-rng": ("y = torch.randn(4, device=x.device)",
                   "y = torch.randn(4, device=x.device, generator=g)"),
    "counter": ("step.calls += 1", "n = 0\n        n += 1"),
    "branch": ("if x.sum() > 0:\n            x = -x",
               "if x.shape[0] > 1:\n            x = -x"),
    "static-branch": ("if x:\n            x = -x",
                      "if n_steps > 1:\n            x = -x"),
    "clock": ("t = time.time()", "t = 0"),
    "print": ("print(x.shape)", "s = str(x.shape)"),
}


@pytest.fixture
def one_root(monkeypatch):
    def use(qualname, static=("n_steps",), path="repro_torch/models/lm.py"):
        monkeypatch.setattr(purity, "CAPTURE_ROOTS", (
            purity.CaptureRoot("test", path, qualname, static),))
        monkeypatch.setattr(purity, "LEAVES", {})
    return use


@pytest.mark.parametrize("fires", [True, False])
@pytest.mark.parametrize("case", sorted(ROOT_PAIRS))
def test_purity_pair(case, fires, tmp_path, one_root):
    one_root("step")
    body = ROOT_PAIRS[case][0 if fires else 1]
    p = ta.load_project(_write(tmp_path, {
        "repro_torch/models/lm.py": _ROOT.format(body=body)}))
    fs = purity.check(p)
    assert bool(fs) == fires, fs
    if fires:
        want = "_helper" if case == "callee-sync" else "step"
        assert {f.qualname for f in fs} == {want}
        assert all(f.rule == "traced-purity" for f in fs)


_WRAPPER = """
    import torch


    def _on_cuda(q):
        return q.device.type == "cuda"


    def op_plain(x):
        return x.sum().item()


    def op(x):
        if {test}:
            {first}
        else:
            {second}
        return x
"""
# (the test, whether its branch is the CPU's)
CPU_TESTS = {"not _on_cuda(x)": True, "_on_cuda(x)": False,
             'x.device.type == "cpu"': True, 'x.device.type != "cpu"': False,
             'x.device.type == "cuda"': False, "x.is_cpu": True,
             "x.is_cuda": False, "not x.is_cuda": True}


@pytest.mark.parametrize("sync_on_card", [True, False])
@pytest.mark.parametrize("test", sorted(CPU_TESTS))
def test_purity_skips_the_cpu_branch(test, sync_on_card, tmp_path,
                                     one_root):
    """The plain version (with its pull) under the CPU branch is never
    walked; a pull on the card's branch is found."""
    one_root("op", static=(), path="repro_torch/kernels/k.py")
    cpu = "return op_plain(x)"
    card = "x = x + x.sum().item()" if sync_on_card else "x = x + 1"
    first, second = (cpu, card) if CPU_TESTS[test] else (card, cpu)
    p = ta.load_project(_write(tmp_path, {
        "repro_torch/kernels/k.py": _WRAPPER.format(test=test, first=first,
                                                    second=second)}))
    fs = purity.check(p)
    assert [(f.qualname, "item" in f.message) for f in fs] == (
        [("op", True)] if sync_on_card else [])


def test_purity_walks_functions_passed_as_arguments(tmp_path, one_root):
    """``per_shard(flash.flash_attention, q, k, v)``: the function handed
    over is walked too."""
    one_root("step")
    p = ta.load_project(_write(tmp_path, {
        "repro_torch/models/lm.py": _ROOT.format(
            body="y = apply(_helper, x)")}))
    fs = purity.check(p)
    assert [f.qualname for f in fs] == ["_helper"]


@pytest.fixture(scope="module")
def live():
    return ta.load_project(SRC)


def test_purity_leaves_a_parameter_unresolved(tmp_path, one_root):
    """A parameter called ``attend`` is the caller's function, not
    another function's nested def of that name."""
    one_root("step")
    p = ta.load_project(_write(tmp_path, {"repro_torch/models/lm.py": """
        def other(x):
            def attend(y):
                return y.sum().item()
            return attend(x)


        def pool(attend, x):
            return attend(x)


        def step(x, n_steps: int):
            return pool(lambda y: y + 1, x)
    """}))
    assert purity.check(p) == []


def test_every_capture_root_and_leaf_resolves(live):
    for root in purity.CAPTURE_ROOTS:
        assert purity.resolve_root(live, root) is not None, root
        assert root.site.startswith("repro/") and root.path.startswith(
            "repro_torch/")
        params = {a.arg for a in purity._params(
            purity.resolve_root(live, root)[1].node)}
        assert set(root.static) <= params, root
    for path, qualname in purity.LEAVES:
        assert purity._function(live.module(path), qualname) is not None


def test_a_deleted_root_is_a_finding(tmp_path, one_root):
    one_root("gone")
    p = ta.load_project(_write(tmp_path, {
        "repro_torch/models/lm.py": "def step(x):\n    return x\n"}))
    fs = purity.check(p)
    assert len(fs) == 1 and "does not resolve" in fs[0].message
    assert fs[0].qualname == "gone"


def test_mutation_item_in_decode_steps_paged_is_found(tmp_path):
    """A ``.item()`` put into a copy of the port's ``decode_steps_paged``
    is found there."""
    src = tmp_path / "src"
    shutil.copytree(SRC / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc",
                                                  "analysis", "paper"))
    lm = src / "repro_torch" / "models" / "lm.py"
    lines = lm.read_text().splitlines()
    start = next(i for i, t in enumerate(lines)
                 if t.startswith("def decode_steps_paged("))
    at = next(i for i in range(start, len(lines))
              if lines[i].strip() == "B = tokens.shape[0]")
    lines.insert(at + 1, "    _first = tokens[0].item()")
    lm.write_text("\n".join(lines) + "\n")
    fs = [f for f in ta.run_checkers(ta.load_project(src),
                                     [purity.check])
          if f.path == "repro_torch/models/lm.py"]
    assert [(f.rule, f.line, f.qualname) for f in fs] == [
        ("traced-purity", at + 2, "decode_steps_paged")]
    assert ".item()" in fs[0].message


# ----------------------------- the live tree ---------------------------- #

def test_live_tree_lints_clean(monkeypatch, capsys):
    """``python -m repro_torch.analysis`` exits 0 on src/repro_torch."""
    monkeypatch.setattr(sys, "argv", ["repro_torch.analysis"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module("repro_torch.analysis", run_name="__main__",
                         alter_sys=True)
    out = capsys.readouterr().out
    assert e.value.code == 0, out
    assert "0 new" in out


def test_baseline_entries_are_justified():
    baseline = tcore.load_baseline(REPO / "analysis_baseline_torch.json")
    assert all(e["justification"].strip() for e in baseline.values())


def test_live_sync_sites_are_counted(live):
    """Every device->host pull of the port's serving code keeps
    ``host_syncs`` exact, among them the fused decode block's one pull;
    the engines' uploads are no pulls."""
    p = live
    sites = host_sync.sync_sites(p)
    assert sites and all(s.counted for s in sites)
    eng = p.module("repro_torch/serving/engine.py")
    lines = eng.source.splitlines()
    pull = next(i for i, t in enumerate(lines, 1)
                if "blk_np = blk.cpu().numpy()" in t)
    dev = next(i for i, t in enumerate(lines, 1)
               if "return torch.as_tensor(a, device=self.device)" in t)
    assert any(s.line == pull and s.qualname ==
               "ServeEngine.serve_continuous" for s in sites)
    assert host_sync.sync_class(eng, pull) == "pull"
    assert host_sync.sync_class(eng, dev) == "upload"
    # generate's prompts: an upload of an np.asarray of host data
    prompts = next(i for i, t in enumerate(lines, 1)
                   if "prompts = torch.as_tensor(np.asarray(prompts)" in t)
    assert host_sync.sync_class(eng, prompts) == "upload"


def test_reference_lint_still_clean():
    """The reference's ``scripts/analyze.py`` reports 0 findings over
    src/repro."""
    mod = runpy.run_path(str(REPO / "scripts" / "analyze.py"))
    assert mod["main"]([]) == 0


def test_sinusoid_fill_is_the_old_table():
    """The encoder table's base is filled on the device now (no upload);
    the table is bitwise the one built from ``torch.tensor(10000.0)``."""
    from repro_torch.models import common as cm
    n, d = 37, 24
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0), 2 * dim / d)
    old = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    assert torch.equal(cm.sinusoid(n, d), old)
