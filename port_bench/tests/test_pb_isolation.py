"""What the benchmark imports, by top-level name compared whole: nothing
that it runs loads jax, jaxlib, flax or the JAX package
(keypoint_bench_tpu; the port keypoint_bench_tpu_torch is another name),
and the plain reference loads nothing of the port either."""
import ast
import os

from port_bench.spec import BENCH_DIR, ROOT

JAX = {"jax", "jaxlib", "flax", "keypoint_bench_tpu"}
PORT = "keypoint_bench_tpu_torch"


def _imports(path):
    """Module names a file imports (absolute), anywhere in it."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _file(module):
    base = os.path.join(ROOT, *module.split("."))
    for p in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(p):
            return p
    return None


def closure(paths):
    """Top-level names imported by these files and, through them, by
    every port_bench module they reach."""
    seen, names, todo = set(), set(), list(paths)
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for m in _imports(p):
            names.add(m.split(".")[0])
            if m.split(".")[0] == "port_bench":
                f = _file(m)
                if f:
                    todo.append(f)
    return names


def _bench_files():
    for d, _, files in os.walk(BENCH_DIR):
        if os.path.basename(d) != "tests":
            yield from (os.path.join(d, f) for f in files
                        if f.endswith(".py"))


def test_the_harness_loads_no_jax():
    names = closure([os.path.join(BENCH_DIR, "run.py"), *_bench_files()])
    assert not names & JAX, names & JAX
    assert PORT in names          # it measures the port


def test_the_reference_loads_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "reference")
    names = closure([os.path.join(ref, f) for f in os.listdir(ref)
                     if f.endswith(".py")])
    assert not names & (JAX | {PORT}), names & (JAX | {PORT})
    assert "torch" in names


def test_top_level_names_compare_whole():
    from port_bench.harness import forbidden_modules
    import sys
    sys.modules.setdefault("keypoint_bench_tpu_torch_like", sys)
    try:
        assert "keypoint_bench_tpu" not in forbidden_modules()
    finally:
        del sys.modules["keypoint_bench_tpu_torch_like"]
