"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's)."""
import ast
import subprocess
import sys

from perfbench import run
from perfbench.tests.helpers import ROOT

PB = ROOT / "perfbench"


def test_fresh_interpreter_loads_no_forbidden_module():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import perfbench.run as r, perfbench.harness\n"
            "import perfbench.loops.census, perfbench.loops.service\n"
            "import perfbench.control, perfbench.trace\n"
            "import repro_torch.engine, repro_torch.serve\n"
            "from perfbench.tests.helpers import rehearse\n"
            "rc, line, _ = rehearse('amazon.census', seconds=0.05)\n"
            "assert rc == 0, rc\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & set(run.FORBIDDEN)


def test_forbidden_names_are_whole_words(monkeypatch):
    monkeypatch.setitem(sys.modules, "reproduce_me", sys)
    assert "reproduce_me" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in run.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_side_imports_nothing_of_the_program():
    for f in ("reference.py", "triads.py", "answers.py", "work.py",
              "graphs.py", "control.py", "ops/triad_census.py",
              "ops/degree_stats.py"):
        assert not _imports(PB / f) & {"repro", "repro_torch", "jax"}, f


def test_no_file_of_the_benchmark_imports_jax_or_reads_old_benchmarks():
    for path in PB.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path
        text = path.read_text()
        if "tests" not in path.parts:
            assert "BENCH_census" not in text and "chip_smoke" not in text
