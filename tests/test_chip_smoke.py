"""chip_smoke.py's contract that a CPU host can check: it refuses to run
without a GPU or outside a checkout, and its last line is the result."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_refuses_cpu_platform(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("cards, visible", [
    pytest.param(1, 1, id="1"), pytest.param(4, 4, id="4"),
    pytest.param(1, 4, id="1-of-4"),
])
def test_last_line_is_the_result(cards, visible, monkeypatch, capsys):
    """``count`` is the cards the run used, not the cards it could see."""
    fake = types.SimpleNamespace(platform="gpu",
                                 device_kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jax, "devices", lambda *a: [fake] * visible)
    monkeypatch.setattr(chip_smoke, "gpu_card",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    ran = []
    monkeypatch.setattr(chip_smoke, "phase_one_card",
                        lambda *a: ran.append("one card"))
    monkeypatch.setattr(chip_smoke, "phase_cards4",
                        lambda *a: ran.append("cards4"))
    argv = ["--cards", "4"] if cards == 4 else []
    assert chip_smoke.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": cards}}
    assert any("700.00 W" in ln for ln in lines[:-1])
    assert ran == (["cards4"] if cards == 4 else ["one card"])


def test_failed_check_prints_no_result(monkeypatch, capsys):
    fake = types.SimpleNamespace(platform="gpu", device_kind="H100")
    monkeypatch.setattr(jax, "devices", lambda *a: [fake])
    monkeypatch.setattr(chip_smoke, "gpu_card", lambda: "H100, 700 W")

    def boom(*a):
        chip_smoke.check(False, "image is black")

    monkeypatch.setattr(chip_smoke, "phase_one_card", boom)
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "image is black" in out.err


def test_compiles_charged_to_their_task(monkeypatch):
    from jax._src import compiler

    # restored at teardown, after record_compiles wraps it
    monkeypatch.setattr(compiler, "compile_or_get_cached",
                        compiler.compile_or_get_cached)
    chip_smoke.record_compiles()
    x = jax.numpy.ones((64, 32), jax.numpy.float32)
    done = chip_smoke.run_concurrently([
        ("sum", lambda: jax.jit(lambda a: (a @ a.T).sum(0))(x)),
        ("nothing", lambda: 1),
    ])
    out, _, rec = done["sum"]
    assert out.shape == (64,)
    assert rec["programs"] >= 1 and rec["s"] > 0
    # 8 KiB argument + 64 x 64 temporary at least
    assert rec["bytes"] >= 64 * 32 * 4 + 64 * 64 * 4
    assert "largest program" in chip_smoke.compiled_note(rec)
    assert done["nothing"][2]["programs"] == 0
    assert "not measured" in chip_smoke.compiled_note(done["nothing"][2])


@pytest.mark.parametrize("triton, verdict, wins", [
    ([5.0 + 0.01 * i for i in range(10)], "gain holds", "10/10"),
    ([7.0 + 0.01 * i for i in range(10)], "gain not shown", "0/10"),
    # faster in every pair, but by less than the xla side's own spread
    ([5.95 + 0.1 * i for i in range(10)], "gain not shown", "10/10"),
])
def test_pairs_summary(triton, verdict, wins):
    xla = [6.0 + 0.1 * i for i in range(10)]
    line = chip_smoke._pairs_summary({"xla": xla, "triton": triton})
    assert verdict in line and f"faster in {wins} pairs" in line
