"""chip_smoke.py: what can be checked without the card (it refuses to
run, it formats its last line, --four-cards selects one phase), and the
on-card run itself behind the `gpu` marker."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def gpu_present():
    import jax

    try:
        platforms = {d.platform for d in jax.devices("gpu")}
    except RuntimeError:
        platforms = set()
    if "gpu" not in platforms:
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on the card")


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_result_line_format(smoke):
    line = smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu",'
                    ' "kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_four_cards_runs_only_that_phase(smoke, monkeypatch, capsys):
    class FakeDevice:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    import jax

    calls = []
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()] * 4)
    monkeypatch.setattr(smoke, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for name in ("parity_oracle", "parity_goldens", "freerun_phase",
                 "four_cards"):
        monkeypatch.setattr(
            smoke, name,
            lambda *a, _n=name, **k: calls.append(_n),
        )
    assert smoke.main(["--four-cards"]) == 0
    assert calls == ["four_cards"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}

    calls.clear()
    assert smoke.main([]) == 0
    assert "four_cards" not in calls and "freerun_phase" in calls


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_present):
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
