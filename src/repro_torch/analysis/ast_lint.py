"""Source lint for capture and bitwise hazards in ``src/repro_torch/``
(the counterpart of ``repro/analysis/ast_lint.py``).

Some contracts are idioms in the SOURCE, invisible once traced: the
reciprocal multiply that keeps the mean bit for bit, or an accumulator's
type inside a CUDA kernel.  :func:`lint_tree` walks every ``.py`` under a
root and every ``csrc/*.cu`` beside it; :func:`lint_source` lints one
Python string and :func:`lint_cuda_source` one CUDA string (the self-test
plants use them).

Rules (the catalog is the docstring of :mod:`repro_torch.analysis`):

  * ``host-in-trace``  -- a host read (``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``float(torch...)``,
    ``torch.cuda.synchronize()``) in a function that also calls ``torch.``
    or ``F.`` compute: it breaks a fake-tensor trace and a CUDA-graph
    capture and forces a device sync when eager.  numpy-only code is not
    device code.
  * ``tracer-branch``  -- ``if``/``while`` on a value produced by a
    ``torch.`` compute call in the same function: a host sync, and a
    branch a capture freezes (warning severity: data flow is
    approximated).
  * ``broadcast-div``  -- ``h / d[:, None]`` or ``h / d.unsqueeze(-1)``
    where a precomputed reciprocal should be multiplied (the bitwise
    rule of the mean).
  * ``acc-dtype``      -- CUDA counterpart of the Pallas scratch-dtype
    rule, over ``csrc/*.cu``: an accumulator declared in a 16-bit type (a
    variable a fold adds into with ``+=``, or named ``acc``/``sum``/...),
    or a ``wgmma`` whose accumulator (D) type is ``f16``.
  * ``grid-arity``     -- CUDA counterpart of the grid/BlockSpec arity
    rule: a wrapper's ctypes ``argtypes`` whose length differs from the
    parameter count of the ``extern "C"`` entry it loads from
    ``csrc/<lib>.cu`` -- a statically incompatible launch.

Suppression pragmas, per rule: ``# analysis: allow(rule-id)`` on the
offending line or the line above, ``# analysis: allow-file(rule-id)``
anywhere in the file; in a ``.cu`` file the same text after ``//``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Set

from repro_torch.analysis.report import AnalysisReport

_ALLOW_LINE = re.compile(r"(?:#|//)\s*analysis:\s*allow\(([a-z0-9\-,\s]+)\)")
_ALLOW_FILE = re.compile(
    r"(?:#|//)\s*analysis:\s*allow-file\(([a-z0-9\-,\s]+)\)")

#: the package's CUDA sources, which ``grid-arity`` reads the entries from
CSRC = Path(__file__).resolve().parents[1] / "csrc"

#: method calls that read a tensor on the host
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")
#: calls under ``torch.`` that are not device compute: construction from
#: host data, dtype/device/grad-mode plumbing, the CUDA runtime's host API
_NOT_COMPUTE = ("torch.device", "torch.dtype", "torch.from_numpy",
                "torch.as_tensor", "torch.tensor", "torch.is_tensor",
                "torch.is_grad_enabled", "torch.no_grad",
                "torch.enable_grad", "torch.set_grad_enabled",
                "torch.inference_mode", "torch.promote_types",
                "torch.finfo", "torch.iinfo", "torch.Generator",
                "torch.manual_seed", "torch.get_default_dtype",
                "torch.library.", "torch.autograd.", "torch.cuda.",
                "torch.backends.", "torch.distributed.", "torch.profiler.",
                "torch.utils.", "torch._", "torch.ops.")
_SYNC_CALLS = ("torch.cuda.synchronize",)


def _remediation() -> str:
    """The host-in-trace fix, verbatim from the error ``kernels.ops.seg_agg``
    raises under a trace (``SEG_AGG_REMEDIATION``): the finding and the
    ValueError agree on the remediation text."""
    from repro_torch.kernels.ops import SEG_AGG_REMEDIATION
    return SEG_AGG_REMEDIATION


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('' when not a name)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_compute(name: str) -> bool:
    """A ``torch.``/``F.`` call that does device work."""
    if name.startswith("F."):
        return True
    return name.startswith("torch.") and not name.startswith(_NOT_COMPUTE)


def _parse_pragmas(src: str):
    """(file-level allowed rules, line -> allowed rules) from pragmas."""
    file_rules: Set[str] = set()
    line_rules: Dict[int, Set[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _ALLOW_FILE.search(line)
        if m:
            file_rules |= {r.strip() for r in m.group(1).split(",")}
        m = _ALLOW_LINE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",")}
            line_rules.setdefault(i, set()).update(rules)
            line_rules.setdefault(i + 1, set()).update(rules)
    return file_rules, line_rules


class _Filter:
    """Adds findings to a report through one file's pragmas."""

    def __init__(self, src: str, filename: str, report: AnalysisReport):
        self.src = src
        self.filename = filename
        self.report = report
        self.file_allow, self.line_allow = _parse_pragmas(src)

    def add(self, rule: str, severity: str, line: int, message: str,
            detail: str = "") -> None:
        if rule in self.file_allow or rule in self.line_allow.get(line, ()):
            return
        self.report.add(rule, severity, f"{self.filename}:{line}", message,
                        detail)


class _FileLint(_Filter):
    """One Python file's AST pass."""

    def __init__(self, src: str, filename: str, report: AnalysisReport,
                 csrc: Optional[Mapping[str, str]]):
        super().__init__(src, filename, report)
        self.csrc = csrc

    def _segment(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.src, node) or ""

    # -- per-function rules -------------------------------------------------

    def check_function(self, fn: ast.FunctionDef) -> None:
        compute = False
        host_sites: List = []            # (line, label)
        torch_names: Set[str] = set()
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call):
                name = _dotted(node.func)
                if _is_compute(name):
                    compute = True
                if name in _SYNC_CALLS:
                    host_sites.append((node.lineno, f"{name}()"))
                elif name in ("float", "int", "bool") and node.args:
                    if any(isinstance(n, ast.Call) and
                           _is_compute(_dotted(n.func))
                           for n in ast.walk(node.args[0])):
                        seg = self._segment(node.args[0])
                        host_sites.append((node.lineno,
                                           f"{name}({seg[:40]})"))
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _HOST_METHODS and \
                        not name.startswith(("np.", "numpy.")):
                    host_sites.append((node.lineno,
                                       f".{node.func.attr}()"))
            elif isinstance(node, ast.Assign) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    isinstance(node.value, ast.Call) and \
                    _is_compute(_dotted(node.value.func)):
                torch_names.add(node.targets[0].id)
        if compute:
            for line, label in host_sites:
                self.add("host-in-trace", "error", line,
                         f"host read {label} in a function that does "
                         "device compute",
                         f"in function {fn.name!r}; {_remediation()}")
        self._check_tracer_branch(fn, torch_names)

    def _check_tracer_branch(self, fn: ast.FunctionDef,
                             torch_names: Set[str]) -> None:
        def suspect(test: ast.AST) -> Optional[str]:
            if isinstance(test, ast.Name) and test.id in torch_names:
                return test.id
            if isinstance(test, ast.Compare):
                if any(isinstance(op, (ast.Is, ast.IsNot))
                       for op in test.ops):
                    return None
                if isinstance(test.left, ast.Name) and \
                        test.left.id in torch_names:
                    return test.left.id
            if isinstance(test, ast.UnaryOp) and \
                    isinstance(test.op, ast.Not):
                return suspect(test.operand)
            if isinstance(test, ast.BoolOp):
                for v in test.values:
                    s = suspect(v)
                    if s:
                        return s
            if isinstance(test, ast.Call) and \
                    isinstance(test.func, ast.Attribute) and \
                    isinstance(test.func.value, ast.Name) and \
                    test.func.value.id in torch_names:
                return test.func.value.id       # if t.any(): ...
            return None

        for node in _own_nodes(fn):
            if isinstance(node, (ast.If, ast.While)):
                name = suspect(node.test)
                if name:
                    self.add("tracer-branch", "warning", node.lineno,
                             f"Python branch on {name!r}, a value produced "
                             "by a torch call",
                             "a host sync, and a branch a CUDA-graph "
                             f"capture freezes, in {fn.name!r}")

    # -- whole-tree rules ---------------------------------------------------

    def check_broadcast_div(self, tree: ast.AST) -> None:
        def is_expand(node: ast.AST) -> bool:
            # expr[..., None] / expr[:, None] / expr.unsqueeze(...)
            if isinstance(node, ast.Subscript):
                sl = node.slice
                return isinstance(sl, ast.Tuple) and any(
                    isinstance(e, ast.Constant) and e.value is None
                    for e in sl.elts)
            return isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "unsqueeze"

        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) \
                    and is_expand(node.right) \
                    and not isinstance(node.left, ast.Constant):
                self.add("broadcast-div", "error", node.lineno,
                         "broadcast division by a [..., None] operand",
                         "precompute the (V, 1) reciprocal and multiply "
                         "(the mean's bitwise rule)")

    def check_argtypes(self, tree: ast.AST) -> None:
        """grid-arity: each ``<fn>.argtypes = ...`` against the entries
        of the library the same function loads."""
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            lib, attr = None, None
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        _dotted(node.func).endswith("_build.load") and \
                        node.args and isinstance(node.args[0], ast.Constant):
                    lib = node.args[0].value
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) and \
                        isinstance(node.value, ast.Call) and \
                        _dotted(node.value.func).endswith("_build.load"):
                    attr = node.attr
            if lib is None:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and \
                        len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Attribute) and \
                        node.targets[0].attr == "argtypes":
                    arity = _list_length(node.value)
                    if arity is None:
                        continue
                    self._check_entries(lib, attr, arity, node.lineno)

    def _check_entries(self, lib: str, attr: Optional[str], arity: int,
                       line: int) -> None:
        src = _cuda_source(lib, self.csrc)
        entries = extern_c_entries(src) if src is not None else {}
        if attr is not None:
            entries = {k: v for k, v in entries.items() if k == attr}
        if not entries:
            self.add("grid-arity", "error", line,
                     f"argtypes for {lib}{'.' + attr if attr else ''}, "
                     "which has no extern \"C\" entry in csrc",
                     f"csrc/{lib}.cu")
            return
        for name, nparams in sorted(entries.items()):
            if nparams != arity:
                self.add("grid-arity", "error", line,
                         f"argtypes has {arity} argument(s) but the "
                         f"extern \"C\" entry {name} takes {nparams}",
                         f"csrc/{lib}.cu: a statically incompatible launch")

    def run(self) -> None:
        tree = ast.parse(self.src, filename=self.filename)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.check_function(node)
        self.check_broadcast_div(tree)
        self.check_argtypes(tree)


def _own_nodes(fn: ast.AST):
    """The nodes of a function's body (its lambdas' too), without those of
    the functions and classes nested in it, each linted on its own."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _list_length(node: ast.AST) -> Optional[int]:
    """The length of a list expression built from list literals, ``*``
    by integer constants and ``+`` (``[c_void_p] * 8 + [c_int] * 11``);
    None when not statically known."""
    if isinstance(node, ast.List):
        return len(node.elts)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            a, b = _list_length(node.left), _list_length(node.right)
            return None if a is None or b is None else a + b
        if isinstance(node.op, ast.Mult):
            for lst, k in ((node.left, node.right), (node.right, node.left)):
                if isinstance(k, ast.Constant) and isinstance(k.value, int):
                    n = _list_length(lst)
                    return None if n is None else n * k.value
    return None


# ---------------------------------------------------------------------------
# CUDA sources
# ---------------------------------------------------------------------------

_EXTERN_C = re.compile(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                       re.S)
#: 16-bit element types a kernel may store in, never accumulate in
_HALF_TYPES = r"(?:__nv_bfloat16|__half|half|bf16|nv_bfloat16)2?"
_HALF_DECL = re.compile(r"\b" + _HALF_TYPES + r"\s+(\w+)\s*(?:\[|=|;)")
_ACC_NAMES = re.compile(r"^(?:acc|accum|sum|total|partial)\w*$", re.I)
_WGMMA_F16_ACC = re.compile(r"wgmma\.mma_async[\w.]*?\.m\d+n\d+k\d+\.f16")


def extern_c_entries(src: str) -> Dict[str, int]:
    """``{entry: parameter count}`` of every ``extern "C"`` function."""
    out = {}
    for m in _EXTERN_C.finditer(_strip_comments(src)):
        params = m.group(2).strip()
        out[m.group(1)] = 0 if params in ("", "void") \
            else params.count(",") + 1
    return out


def _strip_comments(src: str) -> str:
    """C++ source with ``//`` and ``/* */`` comments blanked (line numbers
    kept)."""
    src = re.sub(r"/\*.*?\*/", lambda m: re.sub(r"[^\n]", " ", m.group()),
                 src, flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def _cuda_source(lib: str, csrc: Optional[Mapping[str, str]]
                 ) -> Optional[str]:
    if csrc is not None and lib in csrc:
        return csrc[lib]
    path = CSRC / f"{lib}.cu"
    return path.read_text() if path.is_file() else None


def lint_cuda_source(src: str, filename: str = "<cuda>",
                     report: Optional[AnalysisReport] = None
                     ) -> AnalysisReport:
    """``acc-dtype`` over one CUDA source: a variable declared in a 16-bit
    type that a fold adds into (``name +=`` or ``name = name +``), or that
    is named as an accumulator (``acc``, ``sum``, ``total``, ``partial``),
    and any ``wgmma`` whose accumulator type is ``f16``."""
    report = report if report is not None else AnalysisReport()
    lint = _Filter(src, filename, report)
    code = _strip_comments(src)
    lines = code.splitlines()
    halves: Dict[str, int] = {}
    for i, line in enumerate(lines, start=1):
        for m in _HALF_DECL.finditer(line):
            halves.setdefault(m.group(1), i)
    for name, line in sorted(halves.items(), key=lambda kv: kv[1]):
        adds = re.compile(r"\b" + re.escape(name) +
                          r"\s*(?:\[[^\]]*\])?\s*(?:\+=|=\s*" +
                          re.escape(name) + r"\s*\+)")
        if _ACC_NAMES.match(name) or adds.search(code):
            lint.add("acc-dtype", "error", line,
                     f"accumulator {name!r} declared in a 16-bit type",
                     "a fold must accumulate in f32 and round once at "
                     "the store")
    for i, line in enumerate(lines, start=1):
        if _WGMMA_F16_ACC.search(line):
            lint.add("acc-dtype", "error", i,
                     "wgmma with an f16 accumulator (D) type",
                     "the tensor-core products must accumulate in f32")
    return report


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def lint_source(src: str, filename: str = "<string>",
                report: Optional[AnalysisReport] = None, *,
                csrc: Optional[Mapping[str, str]] = None) -> AnalysisReport:
    """Run every Python source rule over one string; returns the report.

    Suppression pragma comments are honored: ``# analysis: allow(rule)``
    covers its own line and the next, ``# analysis: allow-file(rule)``
    the whole file.  ``csrc`` maps a library name to its CUDA source for
    ``grid-arity`` (default: ``csrc/<lib>.cu`` of this package).  Used
    directly by the self-test plants, so a seeded violation travels the
    same detection path as shipped source.
    """
    report = report if report is not None else AnalysisReport()
    _FileLint(src, filename, report, csrc).run()
    return report


def lint_file(path, report: Optional[AnalysisReport] = None
              ) -> AnalysisReport:
    """Lint one ``.py`` or ``.cu`` file from disk (path shown in
    findings)."""
    p = Path(path)
    if p.suffix == ".cu":
        return lint_cuda_source(p.read_text(), str(p), report)
    return lint_source(p.read_text(), str(p), report)


def lint_tree(root, report: Optional[AnalysisReport] = None
              ) -> AnalysisReport:
    """Lint every ``*.py`` and ``*.cu`` under ``root`` (the shipped-tree
    gate: ``python -m repro_torch.analysis`` points this at
    ``src/repro_torch/``)."""
    report = report if report is not None else AnalysisReport()
    for p in sorted(Path(root).rglob("*.py")) + \
            sorted(Path(root).rglob("*.cu")):
        lint_file(p, report)
    return report
