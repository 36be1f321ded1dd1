"""The port's import graph, read from the source: every `import` of a
`tpu_ray_torch` module in every module of the package, at module level and
inside functions.

The port imports in one direction, from the entry points down through
render/ to the kernel wrappers: no module under kernels/ imports the
render core (`render.render`), and the graph has no cycle but the two that
CYCLES names. Each of those closes through an import inside a function, a
back-edge that CYCLES lists; the test fails when a new cycle appears and
when a listed one is gone, so that the change which removes it takes it
off the list (ROADMAP E3).
"""

from __future__ import annotations

import ast
from pathlib import Path

PKG = "tpu_ray_torch"
ROOT = Path(__file__).resolve().parent.parent / PKG
# the cycles left, each by the import inside a function that closes it:
# (importer, imported)
CYCLES = {
    ("tpu_ray_torch.render.render", "tpu_ray_torch.render.graphs"),
    ("tpu_ray_torch.dist.multihost", "tpu_ray_torch.render.graphs"),
}


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = {_module_name(p): p for p in sorted(ROOT.rglob("*.py"))}


def _targets(node: ast.AST, importer: str) -> list:
    """The package's modules an import statement names."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names if a.name in MODULES]
    if node.level:  # relative: resolved against the importer's package
        base = importer.split(".")
        is_pkg = MODULES[importer].name == "__init__.py"
        base = base[:len(base) - node.level + (1 if is_pkg else 0)]
        mod = ".".join(base + ([node.module] if node.module else []))
    else:
        mod = node.module or ""
    if not mod.startswith(PKG):
        return []
    # `from pkg import sub` names the submodule; `from mod import name` the module
    out = [f"{mod}.{a.name}" for a in node.names if f"{mod}.{a.name}" in MODULES]
    if len(out) < len(node.names) and mod in MODULES:
        out.append(mod)
    return out


def _imports(name: str) -> dict:
    """{imported module: "module" or "function"} of one module: where its
    first import of each sits (module level wins)."""
    tree = ast.parse(MODULES[name].read_text())
    found = {}

    def visit(node, in_function: bool):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for target in _targets(node, name):
                if target != name and found.get(target) != "module":
                    found[target] = "function" if in_function else "module"
        inner = in_function or isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                 ast.Lambda))
        for child in ast.iter_child_nodes(node):
            visit(child, inner)

    visit(tree, False)
    return found


GRAPH = {name: _imports(name) for name in MODULES}


def _cycle_from(start: str, edges: dict):
    """A cycle reachable from start, as a list of modules, or None."""
    state, stack = {}, []

    def walk(node):
        state[node] = "open"
        stack.append(node)
        for nxt in sorted(edges[node]):
            if state.get(nxt) == "open":
                return stack[stack.index(nxt):] + [nxt]
            if nxt not in state:
                found = walk(nxt)
                if found:
                    return found
        stack.pop()
        state[node] = "done"
        return None

    return walk(start)


def test_import_graph_is_read():
    """The reader sees both kinds of import: the render core's module-level
    imports of the wrappers and the cycles' imports inside functions."""
    render = GRAPH["tpu_ray_torch.render.render"]
    assert render["tpu_ray_torch.kernels.cuda_shade"] == "module"
    for importer, imported in CYCLES:
        assert GRAPH[importer].get(imported) == "function", (
            f"{importer} no longer imports {imported} inside a function: "
            "take the pair off CYCLES")
    n_module = sum(v == "module" for g in GRAPH.values() for v in g.values())
    n_function = sum(v == "function" for g in GRAPH.values() for v in g.values())
    assert n_module > 100 and n_function > 10


def test_kernel_wrappers_import_no_render_core():
    """No module under kernels/ imports the render core or the frame's
    graphs, at module level or inside a function."""
    core = {"tpu_ray_torch.render.render", "tpu_ray_torch.render.graphs"}
    bad = {m: core & set(g) for m, g in GRAPH.items()
           if m.startswith(f"{PKG}.kernels") and core & set(g)}
    assert not bad


def test_import_graph_has_no_cycle_but_the_named_ones():
    """With the named back-edges taken out, the graph is acyclic; each named
    pair closes a cycle of the whole graph."""
    cut = {m: {t for t in g if (m, t) not in CYCLES} for m, g in GRAPH.items()}
    for name in sorted(cut):
        cycle = _cycle_from(name, cut)
        assert cycle is None, f"an import cycle: {' -> '.join(cycle)}"
    for importer, imported in CYCLES:
        seen, todo = set(), [imported]
        while todo:
            node = todo.pop()
            if node not in seen:
                seen.add(node)
                todo.extend(GRAPH[node])
        assert importer in seen, f"{importer} -> {imported} closes no cycle: take it off CYCLES"
