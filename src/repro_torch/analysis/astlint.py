"""AST lint layer: the port's contract rules over ``src/repro_torch/``.

The engine builds a best-effort interprocedural view of the package —
imports, functions (nested closures, methods and lambdas included), a
call graph with function-valued arguments and returns — then evaluates
the rules in ``repro_torch.analysis.rules``:

R1  every body BUILDER in ``repro_torch.retrieval.*`` (a function that
    defines and returns a nested function, or returns what another
    builder returns) must reach ``tracing.record_trace()`` through its
    calls, or be called only by builders that do and return its result
    (``engine._mesh_search`` under ``make_segmented_search_fn``). A port
    has no jit site: what is built once and then served is the builder's
    returned closure.
R2  in ``repro_torch.kernels.*.ops``, every function that calls a
    ``*_launch`` entry of a library from ``kernels.build.library`` must
    reach ``dispatch.record()``; every name a ``record`` call can pass
    (string constants, through conditional expressions and the call
    sites of a parameter) must be in ``dispatch.KERNELS``; a launch
    outside those modules is a finding.
R3  host-sync idioms in BODY SCOPE (the closures R1's builders return,
    ``rules.R3_BODY_ROOTS``, and every port function they call):
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``torch.tensor`` (a blocking copy from the host),
    ``torch.cuda.synchronize``, ``Event``/``Stream.synchronize``,
    ``nonzero``/``unique``/``masked_select``; ``np.asarray``/
    ``np.array`` of a parameter; ``float()``/``int()``/``bool()`` of a
    tensor parameter (or an expression on one that is not a host
    attribute such as ``.shape``; a parameter annotated ``int``/``bool``/
    ... is not a tensor); a Python ``if``/``while`` on a bare parameter
    of a body closure. An explicit synchronize is flagged anywhere in the
    serving modules (except the host side of
    ``rules.R3_HOST_EXEMPT_MODULES``).
R4  vector-key suffix literals (``"_mask"``, ``"_int8"``, ``"_scale"``)
    outside ``retrieval/store.py``.
R5  eager tensor construction at import time: module level, class
    bodies, decorators and default arguments.

Reachability is deliberately asymmetric, as in the JAX package's
auditor: body scope grows only through calls and function-valued
arguments (the edges a body actually follows when it runs), so host-side
builder code never lands in body scope by accident, while the
launch -> ``record`` property propagates through calls, references and
function-valued arguments.

Inline exemption: ``# audit: allow-<RULE> <reason>`` on the finding's
line or the line above.
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis import Finding, dedupe
from repro_torch.analysis import rules as R

PACKAGE = "repro_torch"


def _internal(mod: str) -> bool:
    return mod == PACKAGE or mod.startswith(PACKAGE + ".")


# --- per-function record -------------------------------------------------


class FuncInfo:
    def __init__(self, module: str, qualname: str, node, cls: str | None,
                 parent: str | None):
        self.module = module
        self.qualname = qualname
        self.node = node
        self.cls = cls
        self.parent = parent          # qualname of enclosing function
        self.lineno = getattr(node, "lineno", 0)
        self.params: list = []        # in positional order, then the rest
        self.host_params: set = set()  # annotated with a host type
        self.children: dict = {}      # bare name -> qualname
        self.calls: set = set()       # resolved ids ("mod:qual" or dotted)
        self.refs: set = set()        # function ids referenced (loads)
        self.fn_args: set = set()     # function ids passed as call args
        self.returns_funcs: set = set()
        self.returns_calls: set = set()  # ids whose call results return
        self.aliases: dict = {}       # local name -> ids of called funcs
        self.lib_vars: set = set()    # locals bound to build.library()
        self.launches: list = []      # (lineno, entry) library launches
        self.records: list = []       # (lineno, arg expr) record() calls

    @property
    def fid(self) -> str:
        return f"{self.module}:{self.qualname}"


# --- module analysis -----------------------------------------------------


class ModuleInfo:
    def __init__(self, name: str, path: str, source: str):
        self.name = name
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.imports: dict = {}       # alias -> dotted module
        self.symbols: dict = {}       # alias -> (module, symbol)
        self.funcs: dict = {}         # qualname -> FuncInfo
        self.import_time: list = []   # statements run at import
        self._collect_imports()
        self._collect(self.tree.body, prefix="", cls=None, parent=None)

    # -- imports ---------------------------------------------------------
    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                mod = node.module
                if node.level:           # relative import -> absolutise
                    base = self.name.split(".")[: -node.level]
                    mod = ".".join(base + [node.module])
                for a in node.names:
                    self.symbols[a.asname or a.name] = (mod, a.name)

    # -- function/class collection --------------------------------------
    def _collect(self, body, prefix: str, cls: str | None,
                 parent: str | None, top: bool = True) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                fi = FuncInfo(self.name, qual, node, cls, parent)
                self.funcs[qual] = fi
                if parent is None:
                    # decorators and defaults run when the def runs
                    self.import_time.extend(node.decorator_list)
                    self.import_time.extend(
                        node.args.defaults + [d for d in
                                              node.args.kw_defaults if d])
                else:
                    self.funcs[parent].children[node.name] = qual
                self._collect(node.body, prefix=f"{qual}.<locals>.",
                              cls=cls, parent=qual)
            elif isinstance(node, ast.ClassDef):
                if parent is None:
                    self.import_time.extend(node.decorator_list)
                self._collect(node.body, prefix=f"{prefix}{node.name}.",
                              cls=node.name, parent=parent)
            else:
                if parent is None and top:
                    self.import_time.append(node)   # walked whole
                # descend into compound statements so defs nested under
                # if/for/while/with/try still become functions
                for f in ("body", "orelse", "finalbody"):
                    sub = getattr(node, f, None)
                    if sub and isinstance(sub, list):
                        self._collect(sub, prefix, cls, parent, top=False)
                for h in getattr(node, "handlers", []) or []:
                    self._collect(h.body, prefix, cls, parent, top=False)

    # -- name resolution -------------------------------------------------
    def _dotted(self, node) -> str | None:
        """Flatten a Name/Attribute chain to a dotted string."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return None

    def resolve_name(self, name: str, scope: FuncInfo | None) -> list:
        """Resolve a bare name to global ids (best effort, may be [])."""
        fi = scope
        while fi is not None:
            if name in fi.children:
                return [f"{self.name}:{fi.children[name]}"]
            if name in fi.aliases:       # x = builder(...)  -> result-of
                return list(fi.aliases[name])
            fi = self.funcs.get(fi.parent) if fi.parent else None
        if name in self.funcs:           # module top-level function
            return [f"{self.name}:{name}"]
        if name in self.symbols:
            mod, sym = self.symbols[name]
            return [f"{mod}:{sym}" if _internal(mod) else f"{mod}.{sym}"]
        if name in self.imports:
            return [self.imports[name]]
        return []

    def resolve_callable(self, node, scope: FuncInfo | None) -> list:
        """Resolve a call target / function reference to ids."""
        if isinstance(node, ast.Name):
            return self.resolve_name(node.id, scope)
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name):
                base = node.value.id
                if base in ("self", "cls") and scope is not None \
                        and scope.cls:
                    meth = self._method(scope, node.attr)
                    return [f"{self.name}:{meth}"] if meth else []
                out = []
                for r in self.resolve_name(base, scope):
                    if isinstance(r, tuple):
                        continue          # attribute on a call-result var
                    if ":" in r:         # package module alias -> symbol
                        mod = r.replace(":", ".")
                        out.append(f"{mod}:{node.attr}" if _internal(mod)
                                   else f"{mod}.{node.attr}")
                    else:
                        out.append(f"{r}:{node.attr}" if _internal(r)
                                   else f"{r}.{node.attr}")
                return out
            dotted = self._dotted(node)
            if dotted:
                head, _, rest = dotted.partition(".")
                if head in self.imports:
                    full = f"{self.imports[head]}.{rest}"
                    if _internal(full):
                        mod, _, sym = full.rpartition(".")
                        return [f"{mod}:{sym}"]
                    return [full]
            return []
        return []

    def _method(self, scope: FuncInfo, attr: str) -> str | None:
        """``self.attr`` inside a method of ``scope.cls``: the method's
        qualname in this module (any nesting of the class)."""
        suffix = f"{scope.cls}.{attr}"
        for q in self.funcs:
            if (q == suffix or q.endswith("." + suffix)) \
                    and "<locals>" not in q[: -len(suffix)]:
                return q
        return None

    def allowed(self, line: int, rule: str) -> bool:
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines) and \
                    f"audit: allow-{rule}" in self.lines[ln - 1]:
                return True
        return False


# --- body analysis -------------------------------------------------------


def _params(node) -> tuple:
    """(names in positional order then the rest, names annotated with a
    host type)."""
    a = node.args
    args = a.posonlyargs + a.args + a.kwonlyargs
    names = [p.arg for p in args]
    for extra in (a.vararg, a.kwarg):
        if extra:
            names.append(extra.arg)
    host = set()
    for p in args:
        ann = getattr(p, "annotation", None)
        if ann is None:
            continue
        text = ast.unparse(ann)
        parts = {t.strip() for t in text.replace("|", ",").split(",")}
        if parts and parts <= R.R3_HOST_ANNOTATIONS | {""}:
            host.add(p.arg)
    return names, host


def _iter_body(fn_node):
    """Walk a function body without descending into nested defs/lambdas.
    Nested defs are yielded but not entered."""
    body = fn_node.body if not isinstance(fn_node, ast.Lambda) \
        else [ast.Expr(fn_node.body)]
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _import_time_nodes(stmts):
    """Every node evaluated at import by ``stmts`` (function and lambda
    bodies excluded: they run when called)."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _has_launch_literal(node) -> bool:
    return any(isinstance(n, ast.Constant) and isinstance(n.value, str)
               and n.value.endswith(R.R2_LAUNCH_SUFFIX)
               for n in ast.walk(node))


class Analyzer:
    """Cross-module lint over {module_name: source}."""

    def __init__(self, sources: dict, paths: dict | None = None):
        self.modules: dict = {}
        for name, src in sources.items():
            path = (paths or {}).get(name, f"<{name}>")
            self.modules[name] = ModuleInfo(name, path, src)
        self.funcs: dict = {}         # fid -> FuncInfo
        self.call_sites: list = []    # (caller FuncInfo, ids, ast.Call)
        self._lambda_n = 0
        for mi in self.modules.values():
            self._analyze_module(mi)
        for mi in self.modules.values():
            for fi in list(mi.funcs.values()):
                self.funcs[fi.fid] = fi
        self.provides_trace = self._fixpoint(
            R.TRACING_RECORD, edges=lambda f: f.calls)
        self.provides_record = self._fixpoint(
            R.DISPATCH_RECORD, edges=lambda f: f.calls | f.refs | f.fn_args)
        self.builders = self._builders()
        self.body_roots = self._body_roots()
        self.body = self._body_scope()

    # -- per-module body walk -------------------------------------------
    def _lambda_info(self, mi: ModuleInfo, scope: FuncInfo,
                     node: ast.Lambda) -> FuncInfo:
        self._lambda_n += 1
        qual = f"{scope.qualname}.<locals>.<lambda#{self._lambda_n}>"
        fi = FuncInfo(mi.name, qual, node, scope.cls, scope.qualname)
        mi.funcs[qual] = fi
        fi.params, fi.host_params = _params(node)
        self._walk_func(mi, fi)
        return fi

    def _analyze_module(self, mi: ModuleInfo) -> None:
        for fi in list(mi.funcs.values()):
            fi.params, fi.host_params = _params(fi.node)
        for fi in list(mi.funcs.values()):
            self._walk_func(mi, fi)

    def _walk_func(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        # bindings first: a use may come before its binding in walk order
        for node in _iter_body(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                tids = mi.resolve_callable(node.value.func, fi)
                name = node.targets[0].id
                if R.BUILD_LIBRARY in tids:
                    fi.lib_vars.add(name)
                called = [t for t in tids
                          if isinstance(t, str) and ":" in t]
                if called:
                    fi.aliases[name] = tuple(("result_of", t)
                                             for t in called)
        for node in _iter_body(fi.node):
            if isinstance(node, ast.Lambda):
                sub = self._lambda_info(mi, fi, node)
                fi.refs.add(sub.fid)
                continue
            if isinstance(node, ast.Call):
                self._handle_call(mi, fi, node)
            elif isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Load):
                for rid in mi.resolve_name(node.id, fi):
                    if isinstance(rid, str) and ":" in rid:
                        fi.refs.add(rid)
            elif isinstance(node, ast.Return) and node.value is not None:
                vals = node.value.elts \
                    if isinstance(node.value, ast.Tuple) else [node.value]
                for v in vals:
                    if isinstance(v, (ast.Name, ast.Attribute)):
                        for rid in mi.resolve_callable(v, fi):
                            if isinstance(rid, tuple):
                                fi.returns_calls.add(rid[1])
                            elif ":" in rid:
                                fi.returns_funcs.add(rid)
                    elif isinstance(v, ast.Call):
                        for rid in mi.resolve_callable(v.func, fi):
                            if isinstance(rid, str) and ":" in rid:
                                fi.returns_calls.add(rid)

    def _handle_call(self, mi: ModuleInfo, fi: FuncInfo,
                     node: ast.Call) -> None:
        ids = mi.resolve_callable(node.func, fi)
        for cid in ids:
            fi.calls.add(cid)
        self.call_sites.append((fi, [i for i in ids if isinstance(i, str)],
                                node))
        # function-valued arguments (sorted(key=...), executor.map(fn))
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Lambda):
                sub = self._lambda_info(mi, fi, arg)
                fi.fn_args.add(sub.fid)
            elif isinstance(arg, (ast.Name, ast.Attribute)):
                for rid in mi.resolve_callable(arg, fi):
                    if isinstance(rid, str) and ":" in rid:
                        fi.fn_args.add(rid)
        if R.DISPATCH_RECORD in ids:
            fi.records.append((node.lineno, node.args[0] if node.args
                               else None))
        # library launches: lib.<name>_launch(...) and
        # getattr(lib, <... "_launch">)(...)
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in fi.lib_vars \
                and f.attr.endswith(R.R2_LAUNCH_SUFFIX):
            fi.launches.append((node.lineno, f.attr))
        elif isinstance(f, ast.Call) and isinstance(f.func, ast.Name) \
                and f.func.id == "getattr" and len(f.args) >= 2 \
                and isinstance(f.args[0], ast.Name) \
                and f.args[0].id in fi.lib_vars \
                and _has_launch_literal(f.args[1]):
            fi.launches.append((node.lineno, ast.unparse(f.args[1])))

    # -- global passes ---------------------------------------------------
    def _returned(self, builder_id: str, seen=None) -> set:
        """What calling ``builder_id`` returns as functions: its returned
        closures and, through ``return other(...)``, the other's."""
        seen = set() if seen is None else seen
        if builder_id in seen:
            return set()
        seen.add(builder_id)
        b = self.funcs.get(builder_id)
        if b is None:
            return set()
        out = set(b.returns_funcs)
        for c in b.returns_calls:
            out |= self._returned(c, seen)
        return out

    def _out_edges(self, fi: FuncInfo, raw: set) -> set:
        """Expand ("result_of", builder) pseudo-edges to what the builder
        returns (falling back to the builder itself) and drop non-ids."""
        out = set()
        for e in raw:
            if isinstance(e, tuple):
                got = self._returned(e[1])
                out |= got if got else {e[1]}
            elif isinstance(e, str):
                out.add(e)
        return out

    def _fixpoint(self, seed_id: str, edges) -> set:
        provides = {fid for fid, fi in self.funcs.items()
                    if seed_id in fi.calls}
        changed = True
        while changed:
            changed = False
            for fid, fi in self.funcs.items():
                if fid in provides:
                    continue
                if self._out_edges(fi, edges(fi)) & provides:
                    provides.add(fid)
                    changed = True
        return provides

    def closures(self, fi: FuncInfo) -> set:
        """The nested functions ``fi`` defines and returns."""
        return {r for r in fi.returns_funcs
                if r in self.funcs and self.funcs[r].parent == fi.qualname
                and self.funcs[r].module == fi.module}

    def _builders(self) -> dict:
        """fid -> FuncInfo of every builder in R1's scope: it returns a
        nested function of its own, or what another builder returns."""
        out = {fid: fi for fid, fi in self.funcs.items()
               if fi.module.startswith(R.R1_SCOPE) and self.closures(fi)}
        changed = True
        while changed:
            changed = False
            for fid, fi in self.funcs.items():
                if fid not in out and fi.module.startswith(R.R1_SCOPE) \
                        and fi.returns_calls & set(out):
                    out[fid] = fi
                    changed = True
        return out

    def builder_ok(self) -> set:
        """Builders that record their build: they reach record_trace()
        through calls, or every in-tree call of them is returned by a
        builder that does."""
        ok = {fid for fid in self.builders if fid in self.provides_trace}
        callers: dict = {fid: [] for fid in self.builders}
        for fi, ids, _ in self.call_sites:
            for i in ids:
                if i in callers:
                    callers[i].append(fi)
        changed = True
        while changed:
            changed = False
            for fid in self.builders:
                cs = callers[fid]
                if fid not in ok and cs and all(
                        c.fid in ok and fid in c.returns_calls for c in cs):
                    ok.add(fid)
                    changed = True
        return ok

    def _body_roots(self) -> set:
        roots = set()
        for fi in self.builders.values():
            roots |= self.closures(fi)
        roots |= {r for r in R.R3_BODY_ROOTS if r in self.funcs}
        return roots

    def _body_scope(self) -> set:
        """Every function a body runs: the roots and what they call or
        take as function-valued arguments."""
        body = set(self.body_roots)
        work = list(body)
        while work:
            fi = self.funcs[work.pop()]
            for nxt in self._out_edges(fi, fi.calls | fi.fn_args):
                if nxt in self.funcs and nxt not in body:
                    body.add(nxt)
                    work.append(nxt)
        return body

    # -- rules -----------------------------------------------------------
    def run(self, select: set | None = None) -> list:
        findings: list = []
        checks = {"R1": self._rule_r1, "R2": self._rule_r2,
                  "R3": self._rule_r3, "R4": self._rule_r4,
                  "R5": self._rule_r5}
        for rule, fn in checks.items():
            if select is None or rule in select:
                findings.extend(fn())
        by_path = {mi.path: mi for mi in self.modules.values()}
        return dedupe([
            f for f in findings
            if f.path not in by_path or
            not by_path[f.path].allowed(f.line, f.rule)])

    def _finding(self, rule: str, mi: ModuleInfo, line: int, symbol: str,
                 message: str) -> Finding:
        return Finding(rule, mi.path, line, symbol, message)

    def _rule_r1(self) -> list:
        ok = self.builder_ok()
        out = []
        for fid, fi in self.builders.items():
            if fid in ok:
                continue
            mi = self.modules[fi.module]
            names = ", ".join(sorted(
                r.split(":", 1)[1] for r in self._returned(fid)))
            out.append(self._finding(
                "R1", mi, fi.lineno, f"{fi.qualname}:builder",
                f"body builder {fi.qualname} (returns {names}) never "
                "reaches tracing.record_trace() — its builds are "
                "invisible to the no-retrace counter"))
        return out

    # R2 ---------------------------------------------------------------
    def _kernel_names(self):
        mi = self.modules.get(R.DISPATCH_MODULE)
        if mi is None:
            return None
        for stmt in mi.tree.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == R.DISPATCH_KERNELS
                    for t in stmt.targets):
                return {n.value for n in ast.walk(stmt.value)
                        if isinstance(n, ast.Constant)
                        and isinstance(n.value, str)}
        return None

    def _arg_for(self, fi: FuncInfo, call: ast.Call, param: str):
        """The expression a call passes for ``fi``'s parameter ``param``."""
        for kw in call.keywords:
            if kw.arg == param:
                return kw.value
        pos = [p.arg for p in fi.node.args.posonlyargs + fi.node.args.args]
        if fi.cls and pos and pos[0] in ("self", "cls") and \
                isinstance(call.func, ast.Attribute):
            pos = pos[1:]
        if param in pos:
            i = pos.index(param)
            if i < len(call.args) and not any(
                    isinstance(a, ast.Starred) for a in call.args[:i + 1]):
                return call.args[i]
        return None

    def _names(self, expr, fi: FuncInfo, depth: int = 0):
        """The string values ``expr`` can take, or None when some cannot
        be known statically."""
        if expr is None or depth > 6:
            return None
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return {expr.value}
        if isinstance(expr, ast.IfExp):
            a = self._names(expr.body, fi, depth)
            b = self._names(expr.orelse, fi, depth)
            return None if a is None or b is None else a | b
        if isinstance(expr, ast.Name) and expr.id in fi.params:
            got, seen = set(), False
            for caller, ids, call in self.call_sites:
                if fi.fid not in ids:
                    continue
                seen = True
                sub = self._names(self._arg_for(fi, call, expr.id), caller,
                                  depth + 1)
                if sub is None:
                    return None
                got |= sub
            return got if seen else None
        return None

    def _rule_r2(self) -> list:
        out = []
        known = self._kernel_names()
        for mi in self.modules.values():
            is_ops = bool(R.R2_OPS_MODULE.match(mi.name))
            for fi in mi.funcs.values():
                for line, entry in fi.launches:
                    if not is_ops:
                        out.append(self._finding(
                            "R2", mi, line, f"{fi.qualname}:launch",
                            f"{fi.qualname} launches {entry} outside the "
                            "repro_torch.kernels.<family>.ops modules — "
                            "out of the launch-count rule's sight"))
                    elif fi.fid not in self.provides_record:
                        out.append(self._finding(
                            "R2", mi, fi.lineno, fi.qualname,
                            f"{fi.qualname} launches {entry} but never "
                            "reaches dispatch.record() — its launches are "
                            "invisible to the launch counters"))
                if known is None:
                    continue
                for line, arg in fi.records:
                    for name in sorted((self._names(arg, fi) or set())
                                       - known):
                        out.append(self._finding(
                            "R2", mi, line, f"{fi.qualname}:record({name})",
                            f"dispatch.record({name!r}) in {fi.qualname} "
                            "— not a counter of dispatch.KERNELS"))
        return out

    # R3 ---------------------------------------------------------------
    def _rule_r3(self) -> list:
        out = []
        for mi in self.modules.values():
            serving = (mi.name.startswith(R.R3_SERVING_SCOPE)
                       and not mi.name.startswith(R.R3_HOST_EXEMPT_MODULES))
            for fi in mi.funcs.values():
                in_body = fi.fid in self.body
                if not (in_body or serving):
                    continue
                root = fi.fid in self.body_roots
                for node in _iter_body(fi.node):
                    out.extend(self._r3_node(mi, fi, node, in_body, root))
        return out

    def _param_root(self, expr, fi: FuncInfo, mi: ModuleInfo):
        """The tensor parameter an expression is computed from (None when
        it is a host value such as ``x.shape[0]`` or not a parameter's)."""
        if isinstance(expr, ast.Name):
            return expr.id if expr.id in fi.params and \
                expr.id not in fi.host_params else None
        if isinstance(expr, ast.Attribute):
            return None if expr.attr in R.R3_HOST_ATTRS \
                else self._param_root(expr.value, fi, mi)
        if isinstance(expr, ast.Subscript):
            return self._param_root(expr.value, fi, mi)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute):
                if f.attr in R.R3_HOST_ATTRS:
                    return None
                ids = mi.resolve_callable(f, fi)
                if any(isinstance(i, str) and i.startswith("torch.")
                       for i in ids):
                    for a in expr.args:
                        p = self._param_root(a, fi, mi)
                        if p:
                            return p
                    return None
                return self._param_root(f.value, fi, mi)
            return None
        if isinstance(expr, ast.BinOp):
            return (self._param_root(expr.left, fi, mi)
                    or self._param_root(expr.right, fi, mi))
        if isinstance(expr, ast.Compare):
            for e in [expr.left] + expr.comparators:
                p = self._param_root(e, fi, mi)
                if p:
                    return p
            return None
        if isinstance(expr, ast.UnaryOp):
            return self._param_root(expr.operand, fi, mi)
        return None

    def _r3_node(self, mi, fi, node, in_body: bool, root: bool) -> list:
        out = []
        where = "body scope" if in_body else "serving module"
        if isinstance(node, ast.Call):
            ids = set(i for i in mi.resolve_callable(node.func, fi)
                      if isinstance(i, str))
            for did, why in R.R3_SYNC_CALLS.items():
                if did in ids and (in_body or did in R.R3_SERVING_SYNC):
                    out.append(self._finding(
                        "R3", mi, node.lineno, f"{fi.qualname}:{did}",
                        f"{did}() in {where} ({fi.qualname}) — {why}"))
            f = node.func
            if isinstance(f, ast.Attribute) and not ids and \
                    f.attr in R.R3_SYNC_METHODS and \
                    (in_body or f.attr in R.R3_SERVING_SYNC_METHODS):
                out.append(self._finding(
                    "R3", mi, node.lineno, f"{fi.qualname}:.{f.attr}",
                    f".{f.attr}() in {where} ({fi.qualname}) — "
                    f"{R.R3_SYNC_METHODS[f.attr]}"))
            if in_body and node.args:
                if ids & R.R3_NUMPY_ON_PARAM and \
                        isinstance(node.args[0], ast.Name) and \
                        node.args[0].id in fi.params and \
                        node.args[0].id not in fi.host_params:
                    p = node.args[0].id
                    out.append(self._finding(
                        "R3", mi, node.lineno, f"{fi.qualname}:np({p})",
                        f"numpy conversion of parameter `{p}` in body "
                        f"scope ({fi.qualname}) — reads the tensor back "
                        "to the host"))
                elif isinstance(f, ast.Name) and \
                        f.id in R.R3_CAST_BUILTINS and \
                        f.id not in fi.params:
                    p = self._param_root(node.args[0], fi, mi)
                    if p:
                        out.append(self._finding(
                            "R3", mi, node.lineno,
                            f"{fi.qualname}:{f.id}({p})",
                            f"{f.id}() of tensor parameter `{p}` in body "
                            f"scope ({fi.qualname}) — reads a value back "
                            "to the host"))
        elif isinstance(node, (ast.If, ast.While)) and root:
            test = node.test
            neg = isinstance(test, ast.UnaryOp) and \
                isinstance(test.op, ast.Not)
            t = test.operand if neg else test
            if isinstance(t, ast.Name) and t.id in fi.params and \
                    t.id not in fi.host_params:
                out.append(self._finding(
                    "R3", mi, node.lineno, f"{fi.qualname}:if({t.id})",
                    f"Python branch on body parameter `{t.id}` in "
                    f"{fi.qualname} — a tensor's truth value is read back "
                    "to the host"))
        return out

    def _rule_r4(self) -> list:
        out = []
        for mi in self.modules.values():
            if mi.name == R.R4_OWNER_MODULE or \
                    mi.name.startswith(R.R4_EXEMPT_PREFIXES):
                continue
            for node in ast.walk(mi.tree):
                if isinstance(node, ast.Constant) and \
                        isinstance(node.value, str) and \
                        node.value in R.R4_SUFFIXES:
                    out.append(self._finding(
                        "R4", mi, node.lineno,
                        f"literal:{node.value}",
                        f"vector-key suffix literal {node.value!r} "
                        f"outside retrieval/store.py — use the "
                        "VectorSchema accessors"))
        return out

    def _rule_r5(self) -> list:
        out = []
        for mi in self.modules.values():
            for node in _import_time_nodes(mi.import_time):
                if not isinstance(node, ast.Call):
                    continue
                for cid in mi.resolve_callable(node.func, None):
                    if isinstance(cid, str) and (
                            cid in R.R5_TENSOR_CTORS
                            or cid.startswith(R.R5_TENSOR_PREFIXES)):
                        out.append(self._finding(
                            "R5", mi, node.lineno, f"<module>:{cid}",
                            f"{cid}() at import time — allocates before "
                            "any caller has chosen a device"))
        return out


# --- entry points --------------------------------------------------------


def lint_sources(sources: dict, paths: dict | None = None,
                 select: set | None = None) -> list:
    """Lint in-memory {module_name: source}. Test/fixture entry point."""
    return Analyzer(sources, paths).run(select)


def lint_tree(src_root: Path | str, package: str = PACKAGE,
              select: set | None = None,
              repo_root: Path | str | None = None) -> list:
    """Lint every module of ``package`` under ``src_root``."""
    src_root = Path(src_root)
    repo_root = Path(repo_root) if repo_root else src_root.parent
    sources, paths = {}, {}
    for py in sorted((src_root / package).rglob("*.py")):
        rel = py.relative_to(src_root)
        name = ".".join(rel.with_suffix("").parts)
        if name.endswith(".__init__"):
            name = name[: -len(".__init__")]
        sources[name] = py.read_text()
        try:
            paths[name] = str(py.relative_to(repo_root))
        except ValueError:            # linting a tree outside the repo
            paths[name] = str(py)
    return lint_sources(sources, paths, select)
