"""chip_smoke.py: it must refuse to report a result without the card,
and its own logic must run end to end (its CPU rehearsal)."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(args, cwd, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_fails_without_the_card():
    r = _run([SCRIPT], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_fails_without_the_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    for args in ([str(lone)], [str(lone), "--rehearse"]):
        r = _run(args, tmp_path)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_rehearsal_runs_every_phase_on_cpu():
    r = _run([SCRIPT, "--rehearse"], REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = r.stdout
    for phrase in ("== kernel phase", "== end-to-end phase",
                   "identical se: host == device",
                   "identical pe two-file: host == device",
                   "identical binned se: host == device",
                   "identical se -n: host == device"):
        assert phrase in out
    assert out.strip().splitlines()[-1].startswith('{"ok": true')
    assert '"rehearsal": true' in out.strip().splitlines()[-1]
