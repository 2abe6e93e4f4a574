"""``python -m repro_torch`` (``repro_torch.cli.main``) on CPU meshes: every
subcommand's exit codes, stdout and stderr split, against the reference's
CLI contract (0 done, 1 failed cell or ``--fail-on`` reached, 2 usage
error with one ``error: ...`` line)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.cli import main
from torch_fixtures import mesh_4x2

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
CPU = ["--device", "cpu"]


@pytest.fixture
def cache(tmp_path):
    mesh_4x2()
    return ["--cache-dir", str(tmp_path / "cache")]


def test_configs_lists_the_four_sweep_configs(capsys):
    assert main(["configs"]) == 0
    rows = capsys.readouterr().out.splitlines()[2:]
    assert [r.split("|")[0].strip() for r in rows] == \
        ["paper", "gnmt", "resnet", "serve", "moe-skew", "grok_1_314b",
         "llama4_maverick_400b_a17b", "codeqwen15_7b", "granite_3_2b",
         "qwen3_8b", "granite_20b", "xlstm_1_3b", "chameleon_34b",
         "musicgen_medium", "recurrentgemma_2b"]


def test_sweep_cold_then_warm(tmp_path, cache, capsys):
    args = ["sweep", "--configs", "paper,resnet", "--meshes", "4x2,2x2x2",
            "--algorithms", "ring,hierarchical", "--by-phase", "--lint",
            "--by-link", "--out", str(tmp_path / "out"), *CPU, *cache]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "== sweep summary: 8 cells (4 captured, 0 cache hits) ==" in out
    assert "flat-ring" not in out and "4 (error)" in out
    files = sorted(os.listdir(tmp_path / "out"))
    assert files == ["summary.txt", "sweep.csv", "sweep.html", "sweep.json",
                     "sweep.trace.json"]
    assert (tmp_path / "out" / "sweep.csv").read_text().splitlines()[0] == \
        ("config,mesh,algorithm,num_devices,primitive,calls,payload_bytes,"
         "wire_bytes")
    assert main(args) == 0
    captured = capsys.readouterr()
    assert "== sweep summary: 8 cells (0 captured, 8 cache hits) ==" \
        in captured.out
    assert captured.out.count("[cache] hit") == 8


def test_sweep_jobs_and_usage_errors(tmp_path, cache, capsys):
    base = ["sweep", "--out", str(tmp_path / "o"), *CPU, *cache]
    assert main(base + ["--configs", "paper", "-j", "2"]) == 0
    capsys.readouterr()
    assert main(base + ["--configs", "nope"]) == 2
    assert "error: unknown config(s) ['nope']" in capsys.readouterr().err
    assert main(base + ["--configs", "paper", "--jobs", "many"]) == 2
    assert "error: --jobs wants an int or 'auto'" in capsys.readouterr().err
    assert main(base + ["--configs", "paper", "--meshes", "2x2x2x2"]) == 2
    assert "error: mesh spec" in capsys.readouterr().err
    assert main(base + ["--configs", "paper", "--algorithms", "bogus"]) == 2
    assert capsys.readouterr().err.startswith("error:")
    assert main(base + ["--configs", "paper", "--meshes", "16"]) == 1
    assert "no cell finished" in capsys.readouterr().err


def test_sweep_scale_curve(tmp_path, cache, capsys):
    out = tmp_path / "scale"
    assert main(["sweep", "--scale-curve", "--configs", "paper",
                 "--scale-points", "256,1024", "--out", str(out), *CPU,
                 *cache]) == 0
    assert "== scale curves: 2 points over 1 base cells ==" in \
        capsys.readouterr().out
    lines = (out / "scale_curve.csv").read_text().splitlines()
    assert len(lines[0].split(",")) == 13 and len(lines) == 3
    assert "<svg" in (out / "scale_curve.html").read_text()
    assert main(["sweep", "--scale-curve", "--configs", "paper",
                 "--scale-points", "a,b", *CPU, *cache]) == 2


def test_monitor_config_with_every_format(tmp_path, cache, capsys):
    out = tmp_path / "mon"
    assert main(["monitor", "serve", "--formats", "json,csv,html,perfetto",
                 "--out", str(out), *CPU, *cache]) == 0
    text = capsys.readouterr().out
    assert "### CommReport: serve@4x2 (8 devices) ###" in text
    assert sorted(os.listdir(out)) == ["serve.csv", "serve.html",
                                       "serve.json", "serve.trace.json"]
    page = (out / "serve.html").read_text()
    for phase in ("prefill", "decode"):
        assert page.count(f"<h3>phase {phase}: all primitives</h3>") == 1
    assert main(["monitor", "nope", *CPU, *cache]) == 2
    assert "neither a .py file nor a config" in capsys.readouterr().err


def test_monitor_script(tmp_path, capsys):
    ok = tmp_path / "ok.py"
    ok.write_text("import sys\nprint('script ran', sys.argv[1:])\n")
    assert main(["monitor", str(ok), "--flag"]) == 0
    assert "script ran ['--flag']" in capsys.readouterr().out
    bad = tmp_path / "bad.py"
    bad.write_text("raise RuntimeError('boom')\n")
    assert main(["monitor", str(bad)]) == 1
    assert "RuntimeError: boom" in capsys.readouterr().err


@pytest.mark.parametrize("algorithm,code", [("ring", 1),
                                            ("hierarchical", 0)])
def test_lint_exit_codes(algorithm, code, cache, capsys):
    assert main(["lint", "paper", "--mesh", "2x2x2", "--algorithms",
                 algorithm, "--fail-on", "error", *CPU, *cache]) == code
    out = capsys.readouterr().out
    assert ("flat-ring-multipod" in out) == (code == 1)


def test_lint_json_is_pure_json(cache, capsys):
    assert main(["lint", str(FIXTURES / "serve_report.json"),
                 "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["max_severity"] is None
    assert main(["lint", "paper", "--mesh", "2x2x2", "--json",
                 "--algorithms", "ring", *CPU, *cache]) == 0
    captured = capsys.readouterr()
    doc = json.loads(captured.out)          # logs went to stderr
    assert doc["max_severity"] == "error"
    assert "[sweep] capture" in captured.err
    assert main(["lint", "nope", *CPU, *cache]) == 2


def test_compare_exit_codes_and_exports(tmp_path, capsys):
    trace, model = str(FIXTURES / "serve_trace.csv"), \
        str(FIXTURES / "serve_report.json")
    assert main(["compare", trace, model, "--fail-on", "rel-err=0.15",
                 "--formats", "csv,html", "--out", str(tmp_path)]) == 0
    captured = capsys.readouterr()
    assert "modeled vs measured" in captured.out
    assert sorted(os.listdir(tmp_path)) == ["serve_trace_compare.csv",
                                            "serve_trace_compare.html"]
    assert main(["compare", trace, model, "--fail-on",
                 "rel-err=0.01"]) == 1
    assert "exceeds --fail-on" in capsys.readouterr().err
    assert main(["compare", trace, model, "--fail-on", "err=1"]) == 2
    assert main(["compare", trace, "--fmt", "xml"]) == 2
    assert main(["compare", trace, model, "--formats", "pdf"]) == 2
    assert main(["compare", str(tmp_path / "none.csv"), model]) == 2


def test_compare_json_and_saved_import(tmp_path, capsys):
    trace = str(FIXTURES / "translation_trace.json")
    saved = str(tmp_path / "imported.json")
    assert main(["compare", trace, "--json", "--save-import", saved]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["stats"]["unmatched_measured"] == 0
    assert main(["compare", saved, "--fail-on", "rel-err=0.01"]) == 0
    assert "loaded saved report" in capsys.readouterr().err


def test_report_reexports(tmp_path, capsys):
    assert main(["report", str(FIXTURES / "translation_report.json"),
                 "--formats", "html,csv,json", "--out", str(tmp_path),
                 "--render"]) == 0
    out = capsys.readouterr().out
    assert "### CommReport:" in out
    assert sorted(os.listdir(tmp_path)) == [
        "translation_report.csv", "translation_report.html",
        "translation_report.json"]
    assert main(["report", str(FIXTURES / "serve_report.json"),
                 "--formats", "xml", "--out", str(tmp_path)]) == 2
    assert main(["report", str(tmp_path / "none.json")]) == 2


def test_cache_list_and_clear(tmp_path, cache, capsys):
    assert main(["sweep", "--configs", "paper", "--out",
                 str(tmp_path / "o"), *CPU, *cache]) == 0
    capsys.readouterr()
    assert main(["cache", *cache]) == 0
    out = capsys.readouterr().out
    assert ": 1 entries," in out and "paper mesh=4x2 alg=ring" in out
    assert main(["cache", "--clear", *cache]) == 0
    assert "cleared 1 entries" in capsys.readouterr().out
    assert main(["cache", *cache]) == 0
    assert ": 0 entries, 0 bytes" in capsys.readouterr().out


def test_cuda_capture_without_a_device_is_a_usage_error(cache, capsys,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["sweep", "--configs", "paper", *cache]) == 2
    assert "pass --device cpu" in capsys.readouterr().err


def test_unrecognized_arguments_and_left_out_commands(capsys):
    with pytest.raises(SystemExit) as e:
        main(["configs", "--bogus"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        main(["bench"])
    assert e.value.code == 2
    assert "invalid choice: 'bench'" in capsys.readouterr().err
    # dryrun is offered: its own parser takes the forwarded arguments
    with pytest.raises(SystemExit) as e:
        main(["dryrun"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "python -m repro_torch dryrun" in err and "--all" in err


def test_python_dash_m_entry_point():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "configs"],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "serve" in proc.stdout
    assert not any(m in proc.stderr for m in ("jax", "Traceback"))
