"""The port's examples (``optik_tpu_torch/examples``) run from a checkout,
on the CPU (``--device cpu``; on a GPU host their default is the card), each
in a fresh interpreter that must not import jax."""

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "optik_tpu_torch" / "examples"


@pytest.mark.parametrize("script,args,marker", [
    ("example.py", ["--n", "40"], "Success rate: "),
    ("example_diff_ik.py", [], "ok: V_tgt == V*/alpha on every lane"),
    ("diff_ik.py", [], "--- t=0.9"),
])
def test_example_runs_on_the_cpu(script, args, marker):
    code = ("import runpy, sys\n"
            f"sys.argv = [{str(EXAMPLES / script)!r}, '--device', 'cpu', "
            f"*{args!r}]\n"
            "try:\n"
            f"    runpy.run_path({str(EXAMPLES / script)!r}, "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'optik_tpu'))\n"
            "print('imported:', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd="/",
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert marker in out.stdout
    assert out.stdout.rstrip().endswith("imported: []")


def test_example_rejects_a_partial_model():
    out = subprocess.run([sys.executable, str(EXAMPLES / "example.py"),
                          "robot.urdf", "--device", "cpu"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "give <robot.urdf>" in out.stderr
