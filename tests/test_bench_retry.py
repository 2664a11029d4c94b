"""bench.py retry wrapper: survives transient child failures and emits
a machine-readable failure JSON when every attempt dies (the perf record
must never be a raw traceback)."""

import importlib.util
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _py(code):
    return [sys.executable, "-c", code]


def test_first_attempt_success_relayed_verbatim(bench):
    result, rc = bench.run_with_retry(
        _py('import json; print(json.dumps({"metric": "m", "value": 1.5,'
            ' "unit": "Mrays/s", "device_count": 1}))'),
        attempts=3, backoff_s=0, log=lambda m: None,
    )
    assert rc == 0
    assert result == {
        "metric": "m", "value": 1.5, "unit": "Mrays/s", "device_count": 1
    }
    assert "attempts" not in result  # clean first try: untouched relay


def test_transient_failure_then_success(bench, tmp_path):
    # The fake child fails backend init on its first run and succeeds
    # later. State via a marker file.
    marker = tmp_path / "tried"
    code = (
        "import json, os, sys\n"
        f"p = {str(marker)!r}\n"
        "if not os.path.exists(p):\n"
        "    open(p, 'w').close()\n"
        "    raise RuntimeError(\"Unable to initialize backend 'cuda':"
        " UNAVAILABLE\")\n"
        "print(json.dumps({'metric': 'm', 'value': 127.0,"
        " 'unit': 'Mrays/s'}))\n"
    )
    logs = []
    result, rc = bench.run_with_retry(
        _py(code), attempts=3, backoff_s=0, log=logs.append
    )
    assert rc == 0
    assert result["value"] == 127.0
    assert result["attempts"] == 2
    assert any("UNAVAILABLE" in m for m in logs)


def test_persistent_failure_emits_structured_json(bench):
    result, rc = bench.run_with_retry(
        _py("raise RuntimeError(\"Unable to initialize backend 'cuda':"
            " UNAVAILABLE\")"),
        attempts=2, backoff_s=0, log=lambda m: None,
    )
    assert rc == 1
    # The failure record must round-trip as JSON and carry the error.
    line = json.dumps(result)
    parsed = json.loads(line)
    assert parsed["value"] == 0.0
    assert "UNAVAILABLE" in parsed["error"]
    assert parsed["attempts"] == 2
    assert len(parsed["attempt_errors"]) == 2


def test_garbage_stdout_is_a_failure(bench):
    # rc=0 but no parseable JSON line must not be recorded as success.
    result, rc = bench.run_with_retry(
        _py("print('not json')"), attempts=1, backoff_s=0, log=lambda m: None
    )
    assert rc == 1
    assert result["value"] == 0.0


def test_hanging_child_times_out(bench, monkeypatch):
    # A child can hang in backend init instead of failing; each attempt
    # must be bounded so a hang is a retryable failure.
    monkeypatch.setenv("RT_BENCH_TIMEOUT_S", "1")
    result, rc = bench.run_with_retry(
        _py("import time; time.sleep(60)"),
        attempts=2, backoff_s=0, log=lambda m: None,
    )
    assert rc == 1
    assert "timed out" in result["error"]
    assert len(result["attempt_errors"]) == 2


def test_total_budget_stops_retries(bench, monkeypatch):
    # The whole retry budget is bounded so the wrapper emits its JSON
    # before an outer deadline kills it silently.
    monkeypatch.setenv("RT_BENCH_TOTAL_S", "1")
    result, rc = bench.run_with_retry(
        _py("import time; time.sleep(2); raise RuntimeError('x')"),
        attempts=5, backoff_s=0, log=lambda m: None,
    )
    assert rc == 1
    assert result["attempts"] < 5
    assert any("budget" in e for e in result["attempt_errors"])


def test_error_summary_picks_exception_line(bench):
    # JAX appends a traceback-filtering notice AFTER the exception line;
    # the summary must surface the exception, not the notice (seen live:
    # a sweep failure recorded only "For simplicity, JAX has removed...").
    result, rc = bench.run_with_retry(
        _py("import sys;"
            " sys.stderr.write('Traceback (most recent call last):\\n"
            "  ...\\n"
            "ValueError: BlockSpec shape mismatch\\n"
            "For simplicity, JAX has removed its internal frames from the"
            " traceback of the following exception.\\n');"
            " sys.exit(1)"),
        attempts=1, backoff_s=0, log=lambda m: None,
    )
    assert rc == 1
    assert "BlockSpec shape mismatch" in result["error"]


def test_child_env_flag_set(bench):
    # The wrapper must mark the child so it runs the benchmark in-process
    # instead of recursing into another retry wrapper.
    result, rc = bench.run_with_retry(
        _py("import json, os;"
            " print(json.dumps({'metric': os.environ['RT_BENCH_CHILD'],"
            " 'value': 1.0, 'unit': 'u'}))"),
        attempts=1, backoff_s=0, log=lambda m: None,
    )
    assert rc == 0
    assert result["metric"] == "1"


def test_bench_refuses_without_gpu():
    # No CPU fallback: without a GPU the benchmark child prints a JSON
    # error line and exits nonzero.
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu", RT_BENCH_CHILD="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")], env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 1
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "no GPU" in line["error"] and line["value"] == 0.0
