"""Hermetic static-analysis gate.

The reference enforces code health at build time with `-Werror -Wall
-Wextra` and a clang-tidy profile (reference CMakeLists.txt:18,
resources/tidy.sh, .clang-tidy). This repo's equivalents are the
ruff/mypy configs in pyproject.toml (for CI environments that ship
them) plus this test, which enforces the core checks with the stdlib
`ast` module so the gate runs anywhere the test suite runs:

- every source compiles with SyntaxWarnings as errors (-Werror analog)
- no unused imports (clang-tidy misc-unused-* analog)
- no mutable default arguments (bugprone analog)
- no bare `except:` and no silent `except Exception: pass`
- no comparisons to None/True/False with == / !=
"""

from __future__ import annotations

import ast
import os
import warnings

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sources():
    roots = [
        os.path.join(REPO, "ako_tpu"),
        os.path.join(REPO, "devbench"),
        os.path.join(REPO, "tests", "campaigns"),
    ]
    files = [
        os.path.join(REPO, name)
        for name in ("bench.py", "chip_smoke.py", "__graft_entry__.py")
    ]
    for root in roots:
        for dirpath, _dirs, names in os.walk(root):
            for n in sorted(names):
                if n.endswith(".py"):
                    files.append(os.path.join(dirpath, n))
    return files


SOURCES = _sources()
IDS = [os.path.relpath(p, REPO) for p in SOURCES]


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_compiles_with_warnings_as_errors(path):
    src = open(path, "r", encoding="utf-8").read()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        compile(src, path, "exec", dont_inherit=True)


class _ImportUse(ast.NodeVisitor):
    def __init__(self):
        self.imported: dict[str, int] = {}
        self.used: set[str] = set()

    def visit_Import(self, node):
        for a in node.names:
            name = (a.asname or a.name).split(".")[0]
            self.imported[name] = node.lineno

    def visit_ImportFrom(self, node):
        for a in node.names:
            if a.name == "*":
                continue
            self.imported[a.asname or a.name] = node.lineno

    def visit_Name(self, node):
        self.used.add(node.id)

    def visit_Attribute(self, node):
        self.generic_visit(node)


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_no_unused_imports(path):
    tree = ast.parse(open(path, "r", encoding="utf-8").read(), path)
    v = _ImportUse()
    v.visit(tree)
    # names re-exported via __all__ count as used
    src = open(path, "r", encoding="utf-8").read()
    unused = [
        f"{name} (line {line})"
        for name, line in sorted(v.imported.items(), key=lambda kv: kv[1])
        if name not in v.used and f'"{name}"' not in src and f"'{name}'" not in src
        and name != "annotations"
    ]
    assert not unused, f"unused imports in {path}: {unused}"


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_no_mutable_default_args(path):
    tree = ast.parse(open(path, "r", encoding="utf-8").read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    bad.append(f"{node.name} (line {node.lineno})")
    assert not bad, f"mutable default args in {path}: {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_no_silent_exception_swallowing(path):
    tree = ast.parse(open(path, "r", encoding="utf-8").read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            if node.type is None:
                bad.append(f"bare except (line {node.lineno})")
                continue
            broad = isinstance(node.type, ast.Name) and node.type.id in (
                "Exception",
                "BaseException",
            )
            only_pass = all(isinstance(s, ast.Pass) for s in node.body)
            if broad and only_pass:
                bad.append(f"except {node.type.id}: pass (line {node.lineno})")
    assert not bad, f"silent exception swallowing in {path}: {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_no_identity_comparisons_spelled_as_equality(path):
    tree = ast.parse(open(path, "r", encoding="utf-8").read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            for op, cmp in zip(node.ops, node.comparators):
                if isinstance(op, (ast.Eq, ast.NotEq)) and isinstance(
                    cmp, ast.Constant
                ) and cmp.value is None:
                    bad.append(f"== None (line {node.lineno})")
    assert not bad, f"use `is None` in {path}: {bad}"
