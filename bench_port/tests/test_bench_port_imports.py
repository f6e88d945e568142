"""Nothing the benchmark runs imports jax, jaxlib, flax, optax or the JAX
package mqe_tpu, compared by whole top-level name (the port's name,
mqe_tpu_torch, begins with the JAX package's); the reference imports
nothing of the program either."""
import ast
import os
import subprocess
import sys

from bench_port_helpers import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mqe_tpu"}
REF = os.path.join(HERE, "reference", "refsim")


def imported_tops(path):
    """Top-level names of every import in a source file, lazy ones too."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


def sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_under_bench_port_imports_jax_or_the_jax_package():
    for path in sources(HERE):
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"refsim", "torch", "numpy", "__future__", "math", "os", "json", "copy",
               "dataclasses", "functools", "time", "contextlib", "typing"}
    for path in sources(REF):
        tops = imported_tops(path)
        assert "mqe_tpu_torch" not in tops, path
        assert tops <= allowed, (path, tops - allowed)


REHEARSAL = r"""
import sys
sys.path[:0] = [{here!r}, {root!r}]
import torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
from bench_port_helpers import small_cell
from portbench import main
r = main.run(small_cell("go1sheep-hard.gym"), 2**31 + 7, 0.5, False, device="cpu", num_envs=2)
print("TOPS", sorted({{m.split(".", 1)[0] for m in sys.modules}}))
print("FORBIDDEN", main.forbidden_modules())
print("CORRECT", r["correct"])
"""


def test_a_cpu_rehearsal_loads_no_forbidden_module():
    code = REHEARSAL.format(here=HERE, root=ROOT, tests=os.path.dirname(__file__))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.split(" ", 1)[0] in ("TOPS", "FORBIDDEN", "CORRECT"))
    assert lines["FORBIDDEN"] == "[]"
    tops = set(eval(lines["TOPS"]))
    assert not tops & FORBIDDEN and "refsim" in tops and "mqe_tpu_torch" in tops
    assert lines["CORRECT"] == "True"


def test_the_reference_alone_loads_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {os.path.join(HERE, 'reference')!r})\n"
            "import torch\n"
            "from refsim.envs.registry import make_mqe_env\n"
            "from refsim.learn.ppo import PPOTrainer\n"
            "from refsim.learn.mat import MATTrainer\n"
            "w, _ = make_mqe_env('go1sheep-hard', num_envs=2, device='cpu')\n"
            "ts, obs = w.reset()\n"
            "w.step(ts, torch.zeros(2, 2, 3))\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "mqe_tpu_torch" not in tops and not tops & FORBIDDEN
