"""Checker 3 — capture purity (rule ``traced-purity``).

The reference stages its serving, training and sharded bodies into
``jax.jit`` / ``shard_map``; the port calls the same bodies eagerly, and
CUDA-graph capture (ROADMAP P1) is what will stage them. A captured body
replays its device work without running any Python, so a body may not
sync the host (capture fails, or a pulled value is frozen in), draw host
or global randomness, read the clock, print or do I/O, or change host
state (the change happens once, at capture, and never on replay).

``CAPTURE_ROOTS`` maps each of the reference's staging sites to the port
function that stands in its place, with the parameters that the site
bound by ``partial`` or named in ``static_argnames``: the root's static
parameters. A root that no longer resolves is a finding. Each root's
body is walked, with its repo-local callees a few levels deep (a call by
name, through a module alias such as ``kern.paged_decode_attention``, or
through the family dispatch of ``models.api``), for:

* every device->host sync of the host-sync rule, counted or not
  (``.cpu()``, ``.item()``, ``.tolist()``/``.numpy()``/``int``/``float``/
  ``bool``/``np.asarray`` of a device value, ``torch.cuda.synchronize``);
* a blocking upload of host data: ``torch.as_tensor``/``torch.tensor``
  of a host value onto a device, ``.to(device)`` or ``.cuda()`` of one;
* host randomness (``random.*``, ``np.random.*``) and torch's global RNG
  (``torch.rand``/``randn``/``randint``/``normal_``... with no
  ``generator=``);
* ``time.*``, ``datetime.*``, ``print``, ``open``, ``input``;
* a ``torch.distributed`` collective called directly: over gloo it
  stages a CUDA tensor through the host;
* a change to host state: an augmented assignment to an attribute, or
  any assignment to a name declared ``global``.

Device values follow the host-sync rule's taint, seeded at the root's
non-static parameters and, in a callee, at the parameters that receive a
device value; torch factories with a ``device=`` are device values too.
A parameter annotated with a host scalar type (``pos: int``) is a host
value.

Host branching: an ``if``/``while`` of the root's own body whose test
reads a non-static tensor parameter is a finding; ``.shape``,
``.dtype``, ``.device``, ``.is_cuda``, ``.ndim``, ``len``,
``isinstance`` and ``is None`` tests are legal.

The CPU branch: a kernel wrapper takes its plain version only for a
tensor on the CPU, which never runs under capture. The walk does not
enter the branch of an ``if`` that its test selects for a CPU tensor:
``not _on_cuda(x)`` (``CUDA_PREDICATES``), ``x.device.type == "cpu"``,
``x.is_cpu``, ``not x.is_cuda`` (and the ``else`` of their negations).

``LEAVES`` names callees the walk does not enter, each with its reason;
an entry that no longer resolves is a finding.

The reference's Pallas ``index_map`` rule has no counterpart: the port
has no ``index_map``, and its kernels' sources are CUDA, not Python.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.checkers.host_sync import (Taint, callee_name,
                                                    sync_what)
from repro_torch.analysis.core import (Finding, FunctionInfo, ModuleInfo,
                                       Project, attr_chain, call_name)

RULE = "traced-purity"


@dataclass(frozen=True)
class CaptureRoot:
    site: str                  # the reference's staging site, file:line
    path: str                  # the port module of the function in its place
    qualname: str
    static: Tuple[str, ...]    # the site's partial / static_argnames


_SAMPLING = ("temperature", "top_k", "top_p")
_LM = "repro_torch/models/lm.py"
_API = "repro_torch/models/api.py"
_SAMPLE = "repro_torch/models/sampling.py"

CAPTURE_ROOTS: Tuple[CaptureRoot, ...] = (
    CaptureRoot("repro/serving/engine.py:283", _API, "prefill",
                ("cfg", "opts")),
    CaptureRoot("repro/serving/engine.py:284", _API, "decode_step",
                ("cfg", "opts")),
    CaptureRoot("repro/serving/engine.py:290", _API, "decode_steps",
                ("cfg", "opts", "n_steps") + _SAMPLING),
    CaptureRoot("repro/serving/engine.py:354", _LM, "prefill_paged_chunk",
                ("cfg", "opts", "calibrate")),
    CaptureRoot("repro/serving/engine.py:359", _LM, "decode_steps_paged",
                ("cfg", "opts", "eos_id", "n_steps") + _SAMPLING),
    CaptureRoot("repro/serving/engine.py:365", _LM, "spec_decode_verify",
                ("cfg", "opts") + _SAMPLING),
    # the reference's block keys fold (rid, emitted) into the serve seed
    CaptureRoot("repro/serving/engine.py:378", _SAMPLE, "request_keys",
                ("seed",)),
    CaptureRoot("repro/serving/engine.py:379", _SAMPLE, "sample",
                _SAMPLING),
    # the reference binds cfg; the port's copy_pages takes none
    CaptureRoot("repro/serving/engine.py:382", _LM, "copy_pages", ()),
    CaptureRoot("repro/serving/draft.py:178", _LM, "prefill_paged_chunk",
                ("cfg", "opts")),
    CaptureRoot("repro/serving/draft.py:181", _LM, "decode_verify_paged",
                ("cfg", "opts")),
    CaptureRoot("repro/serving/draft.py:184", _LM, "decode_steps_paged",
                ("cfg", "opts", "eos_id", "n_steps")),
    CaptureRoot("repro/train/loop.py:84", "repro_torch/train/loop.py",
                "build_train_step.train_step", ()),
    CaptureRoot("repro/models/moe.py:192", "repro_torch/models/moe.py",
                "_shard_map_path.body", ()),
    CaptureRoot("repro/models/seq_shard_attn.py:86",
                "repro_torch/models/seq_shard_attn.py", "_local_attn_update",
                ("axis", "scale", "softcap", "window")),
)

# callees the walk does not enter: (module, qualname) -> why
LEAVES: Dict[Tuple[str, str], str] = {
    ("repro_torch/kernels/build.py", "kernel"):
        "loads a kernel's library once a process, building it first if it "
        "is missing; a capture follows a warm-up launch, after which it is "
        "a dict lookup",
}

# functions that return True for a tensor on a CUDA device and False for
# one on the CPU (the kernel wrappers' test)
CUDA_PREDICATES = frozenset({"_on_cuda"})

_SHAPE_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                "is_cpu"}
_HOST_ANNOTATIONS = {"int", "float", "bool", "str"}
_TRANSITIVE_DEPTH = 8
_GLOBAL_RNG = {"rand", "randn", "randint", "randperm", "rand_like",
               "randn_like", "randint_like", "normal", "bernoulli",
               "multinomial", "poisson"}
_GLOBAL_RNG_METHODS = {"normal_", "uniform_", "exponential_", "random_",
                       "bernoulli_", "cauchy_", "log_normal_", "geometric_"}
_COLLECTIVES = {"all_gather", "all_reduce", "all_to_all", "broadcast",
                "reduce_scatter", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all_single", "barrier",
                "send", "recv", "gather", "scatter", "reduce"}
_UPLOADS = {"as_tensor", "tensor"}


# --------------------------- resolution ------------------------------- #

def _host_annotated(arg: ast.arg) -> bool:
    ann = arg.annotation
    if ann is None:
        return False
    names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
    return bool(names) and names <= _HOST_ANNOTATIONS | {"Optional"}


def _params(fn: ast.AST) -> List[ast.arg]:
    a = fn.args
    return list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)


def _module_aliases(project: Project, mod: ModuleInfo
                    ) -> Dict[str, ModuleInfo]:
    """{local name: project module} of ``from pkg import submodule [as
    alias]`` imports."""
    out: Dict[str, ModuleInfo] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                target = project._module_for(f"{node.module}.{a.name}", mod,
                                             node.level)
                if target is not None:
                    out[a.asname or a.name] = target
    return out


def _dispatch_table(project: Project, mod: ModuleInfo,
                    fn_name: str) -> List[ModuleInfo]:
    """The modules a family-dispatch function returns: ``fn_name`` is a
    module-level ``def f(..): return TABLE[...]`` whose ``TABLE`` is a
    module-level dict of module aliases (``models.api.module_for``)."""
    fn = next((n for n in mod.tree.body if isinstance(n, ast.FunctionDef)
               and n.name == fn_name), None)
    if fn is None or len(fn.body) != 1 or not isinstance(fn.body[0],
                                                         ast.Return):
        return []
    ret = fn.body[0].value
    if not (isinstance(ret, ast.Subscript)
            and isinstance(ret.value, ast.Name)):
        return []
    aliases = _module_aliases(project, mod)
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == ret.value.id
                        for t in node.targets):
            out = []
            for v in node.value.values:
                if isinstance(v, ast.Name) and v.id in aliases \
                        and aliases[v.id] not in out:
                    out.append(aliases[v.id])
            return out
    return []


def _function(mod: ModuleInfo, qualname: str) -> Optional[FunctionInfo]:
    return next((f for f in mod.functions if f.qualname == qualname), None)


class _Resolver:
    def __init__(self, project: Project):
        self.project = project
        self._memo: Dict[tuple, object] = {}

    def _cached(self, key: tuple, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def refs(self, mod: ModuleInfo, fn: ast.AST, near: str,
             expr: ast.expr) -> List[Tuple[ModuleInfo, FunctionInfo]]:
        """The repo functions the reference ``expr`` (inside ``fn`` of
        ``mod``) may name: a bare name (a def of the module, preferring one
        nested in ``near``, or an import), ``alias.f`` of a submodule
        alias, or ``f`` of a family dispatch (``module_for(cfg).f`` or a
        local bound to it)."""
        chain = attr_chain(expr)
        if len(chain) == 1:
            if chain[0] in {a.arg for a in _params(fn)}:
                return []             # a parameter: the caller's value
            hit = self._cached(("def", mod.rel, chain[0], near),
                               lambda: self.local_def(mod, chain[0], near))
            return [hit] if hit is not None else []
        if len(chain) == 2:
            alias, member = chain
            target = self._cached(
                ("aliases", mod.rel),
                lambda: _module_aliases(self.project, mod)).get(alias)
            if target is not None:
                info = _function(target, member)
                return [(target, info)] if info is not None else []
            mods = self._cached(("bound", id(fn), alias),
                                lambda: self._dispatched(mod, fn, alias))
        elif isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Call):
            member = expr.attr
            name = call_name(expr.value)
            mods = self._cached(
                ("table", mod.rel, name),
                lambda: _dispatch_table(self.project, mod, name))
        else:
            return []
        out = []
        for target in mods:
            info = _function(target, member)
            if info is not None:
                out.append((target, info))
        return out

    def _dispatched(self, mod: ModuleInfo, fn: ast.AST,
                    name: str) -> List[ModuleInfo]:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and any(isinstance(t, ast.Name) and t.id == name
                            for t in node.targets):
                return _dispatch_table(self.project, mod,
                                       call_name(node.value))
        return []

    def local_def(self, mod: ModuleInfo, name: str, near: Optional[str]
                  ) -> Optional[Tuple[ModuleInfo, FunctionInfo]]:
        """The def ``name`` seen from the function ``near``: nested in it
        or in an enclosing function, a module-level def, or an import."""
        scopes = (near or "").split(".")
        for i in range(len(scopes), -1, -1):
            want = ".".join(scopes[:i] + [name]) if i else name
            hit = _function(mod, want)
            if hit is not None:
                return mod, hit
        resolved = self.project.resolve_import(mod, name)
        if resolved is None or not isinstance(resolved[1], ast.FunctionDef):
            return None
        mod2, node = resolved
        info = next((f for f in mod2.functions if f.node is node), None)
        return (mod2, info) if info is not None else None


# ---------------------------- the walk -------------------------------- #

def _device_like(expr: ast.expr) -> bool:
    """An expression naming a device: ``x.device``, a ``device``/``dev``
    name, ``torch.device(..)`` or a "cuda..." string."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value.startswith("cuda")
    if isinstance(expr, ast.Call):
        return attr_chain(expr.func) == ["torch", "device"]
    chain = attr_chain(expr)
    return bool(chain) and (chain[-1] in ("dev", "device")
                            or chain[-1].endswith("_device"))


def _device_seed(call: ast.Call) -> bool:
    """A value placed on a device: a call given a device that is not the
    literal "cpu" (``torch.zeros(.., device=d)``, ``cm.sinusoid(n, d,
    x.device)``)."""
    for kw in call.keywords:
        if kw.arg == "device":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value == "cpu")
    return any(_device_like(a) for a in call.args)


def _banned_call(call: ast.Call, taint: Taint, dist_aliases: Set[str],
                 unknown: Set[str] = frozenset()) -> Optional[str]:
    chain = attr_chain(call.func)
    name = callee_name(call)
    root = chain[0] if chain else ""
    what = sync_what(call, taint)
    if what is not None:
        return f"device->host sync {what}"
    recv = call.func.value if isinstance(call.func, ast.Attribute) else None
    kws = {kw.arg: kw.value for kw in call.keywords if kw.arg}

    def host(x: ast.expr) -> bool:
        return not taint.device(x) and not (isinstance(x, ast.Name)
                                            and x.id in unknown)
    if chain[:1] == ["torch"] and len(chain) == 2 and name in _UPLOADS \
            and "device" in kws and call.args and host(call.args[0]) \
            and not (isinstance(kws["device"], ast.Constant)
                     and kws["device"].value == "cpu"):
        return f"blocking upload torch.{name}(<host value>, device=...)"
    if name == "cuda" and recv is not None \
            and chain[-2:] != ["torch", "cuda"] and host(recv):
        return "blocking upload .cuda() of a host value"
    if name == "to" and recv is not None and host(recv) \
            and ("device" in kws or (call.args
                                     and _device_like(call.args[0]))):
        return "blocking upload .to(device) of a host value"
    if root == "random" and len(chain) > 1:
        return f"host randomness {'.'.join(chain)}()"
    if root in ("np", "numpy") and len(chain) > 2 and chain[1] == "random":
        return f"host randomness {'.'.join(chain)}()"
    if "generator" not in kws and (
            (chain[:1] == ["torch"] and len(chain) == 2
             and name in _GLOBAL_RNG)
            or (name in _GLOBAL_RNG_METHODS and recv is not None)):
        return f"global-RNG draw {'.'.join(chain) or name}() with no " \
               f"generator="
    if root == "time":
        return f"wall clock {'.'.join(chain)}() frozen in at capture"
    if root == "datetime" and len(chain) > 1:
        return f"wall clock {'.'.join(chain)}()"
    if chain == ["print"]:
        return "print() runs at capture only"
    if chain in (["open"], ["input"]):
        return f"host I/O {chain[0]}()"
    if root in dist_aliases and name in _COLLECTIVES:
        return (f"collective {'.'.join(chain)}(): gloo stages a CUDA "
                f"tensor through the host")
    return None


def _dist_aliases(mod: ModuleInfo) -> Set[str]:
    out = set()
    for node in mod.tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    out.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    out.add(a.asname or a.name)
    return out


def cpu_branch(test: ast.expr) -> Optional[str]:
    """"body" or "orelse": the branch of ``if test`` taken for a tensor on
    the CPU, or None when the test is not a device test."""
    neg = isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
    t = test.operand if neg else test
    cuda: Optional[bool] = None          # does t hold for a CUDA tensor?
    if isinstance(t, ast.Call) and call_name(t) in CUDA_PREDICATES:
        cuda = True
    elif isinstance(t, ast.Attribute) and t.attr in ("is_cuda", "is_cpu"):
        cuda = t.attr == "is_cuda"
    elif isinstance(t, ast.Compare) and len(t.ops) == 1 \
            and attr_chain(t.left)[-2:] == ["device", "type"] \
            and isinstance(t.comparators[0], ast.Constant) \
            and t.comparators[0].value in ("cpu", "cuda") \
            and isinstance(t.ops[0], (ast.Eq, ast.NotEq)):
        eq = isinstance(t.ops[0], ast.Eq)
        cuda = eq == (t.comparators[0].value == "cuda")
    if cuda is None:
        return None
    return "orelse" if cuda != neg else "body"


def _cond_violations(cond: ast.expr, traced: Set[str]) -> List[str]:
    """Traced names driving host control flow, minus the legal idioms."""
    allowed: Set[int] = set()

    def mark_allowed(node: ast.AST) -> None:
        for n in ast.walk(node):
            allowed.add(id(n))

    for node in ast.walk(cond):
        if isinstance(node, ast.Compare):
            ops_none = all(isinstance(op, (ast.Is, ast.IsNot))
                           for op in node.ops)
            cmps_none = all(isinstance(c, ast.Constant) and c.value is None
                            for c in node.comparators)
            if ops_none and cmps_none:
                mark_allowed(node)
        elif isinstance(node, ast.Attribute) \
                and node.attr in _SHAPE_ATTRS:
            mark_allowed(node)
        elif isinstance(node, ast.Call) \
                and call_name(node) in ("len", "isinstance", "getattr",
                                        "hasattr"):
            mark_allowed(node)
    return sorted({n.id for n in ast.walk(cond)
                   if isinstance(n, ast.Name) and n.id in traced
                   and id(n) not in allowed})


class _Walk:
    def __init__(self, project: Project):
        self.project = project
        self.resolver = _Resolver(project)
        self.visited: Set[Tuple[str, str, frozenset]] = set()
        self.out: List[Finding] = []

    def function(self, mod: ModuleInfo, info: FunctionInfo,
                 device_params: Set[str], depth: int, top: bool,
                 unknown: Set[str] = frozenset()) -> None:
        """Walk ``info``'s body; ``device_params`` hold device values,
        ``unknown`` are the parameters its caller did not pass (neither
        device nor host: an upload of one is not flagged)."""
        key = (mod.rel, info.qualname, frozenset(device_params),
               frozenset(unknown))
        if key in self.visited or depth > _TRANSITIVE_DEPTH \
                or (mod.rel, info.qualname) in LEAVES:
            return
        self.visited.add(key)
        fn = info.node
        names = set(device_params)
        # a nested def's parameters are unknown values: count them device
        for n in ast.walk(fn):
            if n is not fn and isinstance(n, (ast.FunctionDef, ast.Lambda)):
                names |= {a.arg for a in _params(n)
                          if not _host_annotated(a)}
        taint = Taint(_device_seed, names)
        taint.run(fn)
        dist = _dist_aliases(mod)
        global_names = {g for n in ast.walk(fn) if isinstance(n, ast.Global)
                        for g in n.names}

        def report(node: ast.AST, why: str) -> None:
            self.out.append(Finding(RULE, mod.rel, node.lineno,
                                    info.qualname,
                                    f"{why} (under a capture root)"))

        def visit(node: ast.AST, own: bool) -> None:
            if isinstance(node, ast.If):
                branch = cpu_branch(node.test)
                if own and branch is None:
                    for name in _cond_violations(node.test, device_params):
                        report(node, f"tensor parameter '{name}' drives "
                                     f"host control flow (if/while on a "
                                     f"device value)")
                visit(node.test, own)
                if branch != "body":
                    for s in node.body:
                        visit(s, own)
                if branch != "orelse":
                    for s in node.orelse:
                        visit(s, own)
                return
            if isinstance(node, ast.While) and own:
                for name in _cond_violations(node.test, device_params):
                    report(node, f"tensor parameter '{name}' drives host "
                                 f"control flow (if/while on a device "
                                 f"value)")
            if isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Attribute):
                report(node, f"host state change "
                             f"{'.'.join(attr_chain(node.target)) or 'attr'}"
                             f" += ... runs at capture, not on replay")
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                tgts = (node.targets if isinstance(node, ast.Assign)
                        else [node.target])
                for t in tgts:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and n.id in global_names:
                            report(node, f"host state change: module "
                                         f"global '{n.id}' assigned")
            if isinstance(node, ast.Call):
                why = _banned_call(node, taint, dist, unknown)
                if why is not None:
                    report(node, why)
                else:
                    self.descend(mod, info, node, taint, depth)
            nested = isinstance(node, (ast.FunctionDef, ast.Lambda))
            for child in ast.iter_child_nodes(node):
                visit(child, own and not nested)

        body = fn.body if isinstance(fn, ast.FunctionDef) else [fn.body]
        for stmt in body:
            visit(stmt, top)

    def descend(self, mod: ModuleInfo, info: FunctionInfo, call: ast.Call,
                taint: Taint, depth: int) -> None:
        """Walk what ``call`` reaches: its callee, with the parameters that
        receive a device value as device values and those it does not pass
        as unknown; and each repo function handed to it as an argument
        (``per_shard(flash.flash_attention, q, k, v)``), which the callee
        calls on values the walk cannot see: every parameter a device
        value."""
        for mod2, callee in self.resolver.refs(mod, info.node,
                                               info.qualname, call.func):
            params = _params(callee.node)
            positional = [a.arg for a in list(callee.node.args.posonlyargs)
                          + list(callee.node.args.args)]
            dev: Set[str] = set()
            passed: Set[str] = set()
            for i, a in enumerate(call.args):
                if isinstance(a, ast.Starred):
                    passed |= set(positional[i:])
                    if taint.device(a.value):
                        dev |= set(positional[i:])
                    break
                if i < len(positional):
                    passed.add(positional[i])
                    if taint.device(a):
                        dev.add(positional[i])
            for kw in call.keywords:
                if kw.arg is None:
                    passed |= {a.arg for a in params}
                    if taint.device(kw.value):
                        dev |= {a.arg for a in params}
                else:
                    passed.add(kw.arg)
                    if taint.device(kw.value):
                        dev.add(kw.arg)
            host = {a.arg for a in params if _host_annotated(a)}
            self.function(mod2, callee, dev - host, depth + 1, top=False,
                          unknown={a.arg for a in params} - passed)
        for a in call.args:
            if isinstance(a, (ast.Name, ast.Attribute)):
                for mod2, ref in self.resolver.refs(mod, info.node,
                                                    info.qualname, a):
                    self.function(mod2, ref, {
                        p.arg for p in _params(ref.node)
                        if not _host_annotated(p)}, depth + 1, top=False)


def resolve_root(project: Project, root: CaptureRoot
                 ) -> Optional[Tuple[ModuleInfo, FunctionInfo]]:
    mod = project.module(root.path)
    info = _function(mod, root.qualname) if mod is not None else None
    return (mod, info) if info is not None else None


def root_device_params(info: FunctionInfo, root: CaptureRoot) -> Set[str]:
    return {a.arg for a in _params(info.node)
            if a.arg not in root.static and a.arg not in ("self", "cls")
            and not _host_annotated(a)}


def check(project: Project) -> List[Finding]:
    walk = _Walk(project)
    for root in CAPTURE_ROOTS:
        hit = resolve_root(project, root)
        if hit is None:
            walk.out.append(Finding(
                RULE, root.path, 1, root.qualname,
                f"capture root {root.qualname} (for {root.site}) does not "
                f"resolve"))
            continue
        mod, info = hit
        walk.visited = set()      # a root's own body is walked as a root
        walk.function(mod, info, root_device_params(info, root), 0,
                      top=True)
    for (path, qualname), why in LEAVES.items():
        mod = project.module(path)
        if mod is None or _function(mod, qualname) is None or not why:
            walk.out.append(Finding(
                RULE, path, 1, qualname,
                f"stale leaf: {qualname} is not a function of {path}"))
    seen: Set[str] = set()
    uniq: List[Finding] = []
    for f in walk.out:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            uniq.append(f)
    return uniq
