"""Import hygiene: no file of the benchmark imports JAX or the JAX
package, and the reference imports nothing of the program.  Modules are
compared by their whole top-level name: ``caelo_tpu_torch`` is not
``caelo_tpu``."""
import ast
import glob
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "caelo_tpu"}


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def files(sub=""):
    return sorted(glob.glob(os.path.join(HERE, sub, "**", "*.py"),
                            recursive=True))


def test_no_file_imports_jax_or_the_jax_package():
    assert files()
    for path in files():
        bad = top_level_imports(path) & JAX
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    ref = files("reference")
    assert ref
    for path in ref:
        names = top_level_imports(path)
        assert not names & (JAX | {"caelo_tpu_torch", "perfbench"}), path


def test_the_comparison_is_of_whole_names():
    assert "caelo_tpu_torch".split(".")[0] not in JAX
    assert "caelo_tpu.config".split(".")[0] in JAX
