"""What the benchmark loads: nothing of jax, jaxlib, flax or boda_tpu (top
level names compared whole, so boda_tpu_torch is not boda_tpu), the
reference nothing of the program; and a run without a card gives no
result."""

import subprocess
import sys
import types

from portbench import harness as H

REPO = str(H.CHECKOUT)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, check=True, cwd=REPO).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_the_harness_and_the_program_it_drives_load_no_jax():
    code = "\n".join([
        "import portbench.run, portbench.control, portbench.readers, portbench.program",
        "from portbench import harness as H",
        "[H.traffic_driver(p.stem) for p in (H.ROOT / 'traffic').glob('*.py')]",
        "[H.metric_reader(p.stem) for p in (H.ROOT / 'metrics').glob('*.py')]",
        "import portbench.reference.resnet50, portbench.reference.ssd300",
        "import boda_tpu_torch.modes.serve_bench, boda_tpu_torch.parallel.train",
        "import boda_tpu_torch.models.zoo, boda_tpu_torch.utils.carry, boda_tpu_torch.graph",
        "import boda_tpu_torch.config"])
    mods = _loaded(code)
    assert "boda_tpu_torch" in mods and "torch" in mods
    assert not mods & set(H.FORBIDDEN), mods & set(H.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import portbench.reference.resnet50, portbench.reference.ssd300")
    assert not mods & ({"boda_tpu_torch"} | set(H.FORBIDDEN))


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert "boda_tpu" not in H.forbidden_loaded() or "boda_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "boda_tpu_torch_probe", types.ModuleType("x"))
    assert "boda_tpu" not in H.forbidden_loaded() or "boda_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "boda_tpu.probe", types.ModuleType("x"))
    assert "boda_tpu" in H.forbidden_loaded()


def test_a_run_without_a_card_fails_and_prints_no_result():
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "resnet50.serve_b32",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no CUDA card" in r.stderr
