"""net_tune, net_ab and net_decomp on the CPU.

Their decisions against boda_tpu's: both packages' timers are replaced by
the same fixed function of what is timed (the per-op tune selection an
engine holds, or the cut node a suffix starts from), so that the signature
groups and their order, each group's winner under the margin, the written
wisdom and net_decomp's cuts and stage lines must come out the same. Then
the wisdom read back by run_cnet, net_tune --ab=1 end to end on
``ab_compare``'s host clock, and the errors: the cross-program timers refuse the
CPU, and the modes' default device, the card, raises without one.
"""

import io
import re
import zlib
from contextlib import redirect_stdout

import pytest
import torch

import boda_tpu.modes_all  # noqa: F401
import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu import cli as jcli
from boda_tpu.graph import executor as jexec
from boda_tpu.prof import abtime as jabtime
from boda_tpu_torch import cli
from boda_tpu_torch.graph import executor as texec
from boda_tpu_torch.prof import abtime as tabtime
from boda_tpu_torch.prof.wisdom import read_wisdom

ENGINES = {"jax": "(mode=pallas,compute_tn=bfloat16,precision=default)",
           "torch": "(mode=cuda,compute_tn=bfloat16,device=cpu)"}


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _secs(sel: dict) -> float:
    """A forward's seconds under a per-op tune selection (op -> lexp): 1 ms,
    plus or minus up to 120 us per op on the library (by the op's name), and
    300 us less for a library stem on its fold. Groups of 2-4 ops then win
    by more or by less than the 8% margin."""
    t = 1e-3
    for op, tune in sel.items():
        knobs = dict(kv.split("=") for kv in str(tune).strip("()").split(",") if kv)
        if knobs.get("use_xla") == "1":
            t += ((zlib.crc32(op.encode()) % 7) - 3) * 4e-5
            if op == "conv1" and knobs.get("stem_s2d") == "1":
                t -= 3e-4
    return t


def _inject(monkeypatch):
    """Both packages' engines time as _secs of their selection: time_fwd
    directly, the A/B path through raw functions that return the selection
    they were built under."""
    for cls in (jexec.PallasFwd, texec.CudaFwd):
        monkeypatch.setattr(cls, "time_fwd",
                            lambda self, ins, outs, **kw: _secs(self.per_op_tune))
        monkeypatch.setattr(cls, "build_raw_fn",
                            lambda self, outs: (lambda w, i, sel=dict(self.per_op_tune): sel))
    for mod in (jabtime, tabtime):
        monkeypatch.setattr(mod, "ab_compare", lambda ra, rb, w, ins, **kw:
                            (_secs(ra(w, ins)), _secs(rb(w, ins))))


@pytest.mark.parametrize("ab", ["1", "0"])
def test_net_tune_decisions_match_boda_tpu(ab, tmp_path, monkeypatch):
    _inject(monkeypatch)
    outs, wis = {}, {}
    for pkg, main in (("jax", jcli.main), ("torch", cli.main)):
        d = tmp_path / pkg
        rc, outs[pkg] = _run(main, ["net_tune", "--model=mini_resnet", "--img=2",
                                    f"--ab={ab}", f"--conv-fwd={ENGINES[pkg]}",
                                    f"--boda-output-dir={d}"])
        assert rc == 0, outs[pkg]
        outs[pkg] = outs[pkg].split("TIMERS:")[0]  # boda_tpu's timers, if any ran
        wis[pkg] = [(w.op.key(), [r.tune for r in w.runs])
                    for w in read_wisdom(str(d / "net-tuned.wis"))]

    def decisions(out):
        return [m.groups() for m in re.finditer(
            r"^group (\d+) \(([\d.]+)GF x(\d+) ops\): .* -> (\S+)$", out, re.M)]
    got, want = decisions(outs["torch"]), decisions(outs["jax"])
    assert got == want and len(got) == 9
    assert {w for *_, w in got} >= {"lib", "stem", "(incumbent)"}
    assert wis["torch"] == wis["jax"] and len(wis["torch"]) >= 2
    first = [o.splitlines()[0].split(" (")[0] for o in outs.values()]
    assert first[0] == first[1]
    assert outs["torch"].splitlines()[-1] == outs["jax"].splitlines()[-1]
    if ab == "1":  # the written wisdom, read back by run_cnet's engine
        monkeypatch.undo()
        fn = tmp_path / "torch" / "net-tuned.wis"
        rc, out = _run(cli.main, ["run_cnet", "--model=mini_resnet", "--img=2",
                                  f"--conv-fwd={ENGINES['torch'][:-1]},wisdom_fn={fn})"])
        tuned = {ln.split(":")[0] for ln in out.splitlines()
                 if ": wisdom tune " in ln and " on net:cuda:cpu:" in ln}
        assert rc == 0 and len(tuned) >= len(wis["torch"]), out


def test_net_decomp_matches_boda_tpu(monkeypatch):
    """The auto cuts and every stage line, with each suffix's seconds a fixed
    function of its cut node."""
    order = {}

    def secs(self, ins, outs, **kw):
        cut = next(iter(ins))
        return 2e-3 - 1e-4 * order.setdefault(cut, len(order)) ** 1.5
    for cls in (jexec.XlaFwd, texec.CudaFwd):
        monkeypatch.setattr(cls, "time_fwd", secs)
    argv = ["net_decomp", "--model=mini_resnet", "--img=2", "--repeats=1"]
    jrc, jout = _run(jcli.main, argv + ["--conv-fwd=(mode=xla)"])
    rc, out = _run(cli.main, argv + ["--conv-fwd=(mode=cuda,device=cpu)"])
    assert rc == jrc == 0
    jout = jout.split("TIMERS:")[0]  # boda_tpu's CLI ends with its timers, if any ran
    assert out == jout and "stage ->" in out and len(order) >= 3


def test_net_tune_end_to_end_on_cpu(tmp_path):
    """The in-process A/B on the host clock, end to end (which tune wins is
    the host's noise), and net_ab."""
    eng = "(mode=cuda,device=cpu)"
    rc, out = _run(cli.main, ["net_tune", "--model=mini_resnet", "--img=2", "--ab=1",
                              "--ab-legs=2", "--max-groups=1", "--n-iters=2",
                              "--candidates=(lib=(use_xla=1),kg=(use_xla=0,bm=512))",
                              f"--conv-fwd={eng}", f"--boda-output-dir={tmp_path}"])
    assert rc == 0 and "in-process A/B" in out, out
    # kg resolves to the incumbent's gen tunes (bm does nothing on the card)
    assert re.search(r"^group 0 \(.*\): \{'lib': [\d.]+, '\(incumbent\)': [\d.]+\} -> ", out,
                     re.M), out
    assert (tmp_path / "net-tuned.wis").exists()
    rc, out = _run(cli.main, ["net_ab", "--model=mini_resnet", "--img=2", "--ab-legs=2",
                              f"--a={eng}", "--b=(mode=cuda,device=cpu,kernel_policy=lib)"])
    assert rc == 0 and "B/A speedup" in out


def test_cross_program_timing_refuses_the_cpu(capsys):
    for argv in (["net_decomp", "--model=mini_resnet", "--img=2",
                  "--conv-fwd=(mode=cuda,device=cpu)"],
                 ["net_tune", "--model=mini_resnet", "--img=2", "--ab=0",
                  "--conv-fwd=(mode=cuda,device=cpu)"]):
        assert cli.main(argv) == 1
        assert "time_fwd times the card" in capsys.readouterr().err


def test_default_device_without_card_raises(monkeypatch, capsys):
    """Each tool mode runs on the card by default and raises without one; it
    runs on the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["net_trace", "--model=mini_resnet", "--img=2"],
                 ["train_trace", "--model=mini_resnet", "--img=2"],
                 ["net_tune", "--model=mini_resnet", "--img=2"],
                 ["net_ab", "--model=mini_resnet", "--img=2"],
                 ["net_decomp", "--model=mini_resnet", "--img=2"],
                 ["cnn_prof", "--model=mini_resnet", "--time=1"],
                 ["cnn_op_info", "--ops-fn=testdata/ops/sgemm-ops-tiny.txt", "--time=1"],
                 ["rtc_test", "--n=100"]):
        assert cli.main(argv) == 1, argv
        assert "no CUDA card" in capsys.readouterr().err, argv
