"""The port's source-convention AST lint (port of
`repro/analysis/source_lint.py`), run over `src/repro_torch`.

Kept from the reference:

  * ``wallclock-in-sim`` — the serving runtime is a *deterministic
    simulation*; a wall-clock read inside the engine event loop, the
    batcher, the executor or the tracer silently breaks replay
    determinism.  The legitimate wall-metric sites carry a
    `# lint: allow[wallclock-in-sim]` pragma.
  * ``bare-assert`` — `assert` guarding a compile-pipeline or kernel
    invariant is stripped under `python -O`; those checks must raise.

In place of the reference's `compat-import` and `pyrandom-in-jit` (JAX
conventions with no torch counterpart), the port's standing conventions:

  * ``port-import`` — no import of `jax` or of the reference package
    `repro` anywhere, and no module-level import of `triton`: the port
    must import on a host that has none of them (a kernel module imports
    triton inside the function that launches it).
  * ``torch-random-unkeyed`` — a torch random call (`torch.rand`,
    `randint`, `multinomial`, `Tensor.uniform_`, ...) needs an explicit
    `generator=`: the port draws from the threefry key streams
    (`prng.py`), and a global-RNG draw is neither reproducible nor the
    reference's.
  * ``twin-float-division`` — in a twin (`kernels/`, `core/`,
    `diag/accum.py`) a tensor is never divided by a Python float literal:
    on CUDA `tensor / float` rounds differently from true division; pass
    a 0-dim float32 tensor (`core/interp.py` `scalar`).

Suppression: a ``# lint: allow[rule-id]`` comment on the offending line
or the line directly above silences that rule at that site.
"""

from __future__ import annotations

import ast
import pathlib
import re

from repro_torch.analysis import Finding

# Deterministic-simulation modules: wall-clock reads here break replay.
SIM_FILES = (
    "runtime/engine.py",
    "runtime/executor.py",
    "runtime/batcher.py",
    "obs/tracer.py",
)

# Compile-pipeline + kernel files where a stripped assert means a silent
# correctness hole.
PIPELINE_FILES = ("compile/", "kernels/", "core/bayesnet.py", "core/ky.py")

# Files holding the kernels' plain twins and the datapaths they share.
TWIN_FILES = ("kernels/", "core/", "diag/accum.py")

WALLCLOCK_CALLS = {
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("time", "perf_counter_ns"), ("time", "monotonic_ns"),
    ("datetime", "now"), ("datetime", "utcnow"),
}

FORBIDDEN_IMPORTS = ("jax", "jaxlib", "repro")
LAZY_IMPORTS = ("triton",)

TORCH_RANDOM = {
    "rand", "randn", "randint", "randperm", "multinomial", "bernoulli",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
}
TENSOR_RANDOM = {
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_",
    "cauchy_", "geometric_", "log_normal_",
}

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\[([a-z0-9-]+)\]")


def _allowed(lines: list[str], lineno: int, rule: str) -> bool:
    """Pragma check: `# lint: allow[rule]` on the line or the line above."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _ALLOW_RE.search(lines[ln - 1])
            if m and m.group(1) == rule:
                return True
    return False


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an attribute/name chain ('' if dynamic)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _in(rel: str, scopes) -> bool:
    return any(
        (rel.endswith(s) if s.endswith(".py") else f"/{s}" in f"/{rel}")
        for s in scopes
    )


def _float_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) and isinstance(node.value, float)


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, lines: list[str]):
        self.rel = rel
        self.lines = lines
        self.findings: list[Finding] = []
        self.in_sim = _in(rel, SIM_FILES)
        self.in_pipeline = _in(rel, PIPELINE_FILES)
        self.in_twin = _in(rel, TWIN_FILES)
        self._depth = 0  # function nesting: imports at 0 are module level

    def _emit(self, rule: str, node: ast.AST, message: str, fixit: str = ""):
        if _allowed(self.lines, node.lineno, rule):
            return
        self.findings.append(Finding(
            rule=rule, loc=f"{self.rel}:{node.lineno}",
            message=message, fixit=fixit,
        ))

    # -- port-import ---------------------------------------------------------

    def _check_import(self, module: str, node: ast.AST):
        top = module.split(".")[0]
        if top in FORBIDDEN_IMPORTS:
            self._emit(
                "port-import", node,
                f"import of {module!r}: the port imports neither JAX nor "
                "the reference package",
                fixit="keep a copy of what the port needs in repro_torch",
            )
        elif top in LAZY_IMPORTS and self._depth == 0:
            self._emit(
                "port-import", node,
                f"module-level import of {module!r}",
                fixit="import it inside the function that launches the "
                      "kernel",
            )

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            self._check_import(alias.name, node)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if not node.level:
            self._check_import(node.module or "", node)
        self.generic_visit(node)

    def _visit_func(self, node):
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- calls: wall clock + unkeyed torch RNG --------------------------------

    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func)
        parts = tuple(name.rsplit(".", 2)[-2:]) if "." in name else ()
        if self.in_sim and parts in WALLCLOCK_CALLS:
            self._emit(
                "wallclock-in-sim", node,
                f"{name}() inside a deterministic-simulation module",
                fixit="use the simulated clock, or annotate a genuine "
                      "wall-metric site with `# lint: allow[wallclock-in-sim]`",
            )
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        rng = ((name.startswith("torch.") and attr in TORCH_RANDOM)
               or attr in TENSOR_RANDOM)
        if rng and not any(k.arg == "generator" for k in node.keywords):
            self._emit(
                "torch-random-unkeyed", node,
                f"{name or attr}() draws from torch's global generator",
                fixit="draw from a prng.Key, or pass generator=",
            )
        self.generic_visit(node)

    # -- twins: tensor / python float -----------------------------------------

    def visit_BinOp(self, node: ast.BinOp):
        if (self.in_twin and isinstance(node.op, ast.Div)
                and _float_literal(node.right)):
            self._emit(
                "twin-float-division", node,
                "division by a Python float literal in a twin",
                fixit="divide by core.interp.scalar(x, device) (a 0-dim "
                      "float32 tensor)",
            )
        self.generic_visit(node)

    # -- bare asserts in pipeline files ---------------------------------------

    def visit_Assert(self, node: ast.Assert):
        if self.in_pipeline:
            self._emit(
                "bare-assert", node,
                "bare `assert` guarding a pipeline/kernel invariant is "
                "stripped under `python -O`",
                fixit="raise ScheduleVerificationError / ValueError instead",
            )
        self.generic_visit(node)


def lint_file(path, root=None) -> list[Finding]:
    """Lint one Python source file; `root` anchors the reported path."""
    path = pathlib.Path(path)
    rel = str(path.relative_to(root) if root else path)
    text = path.read_text()
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError as e:
        return [Finding(
            rule="bare-assert", loc=f"{rel}:{e.lineno or 0}",
            message=f"file does not parse: {e.msg}", severity="error",
        )]
    linter = _Linter(rel, text.splitlines())
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: f.loc)


def lint_repo(root) -> list[Finding]:
    """Lint every `.py` under `root` (typically `src/repro_torch`)."""
    root = pathlib.Path(root)
    out: list[Finding] = []
    for path in sorted(root.rglob("*.py")):
        out.extend(lint_file(path, root=root.parent))
    return out
