"""The port's on-disk report cache (``repro_torch.core.report_cache``)
against the reference's semantics: key contents, phase folding, the
capture device in the key, atomic writes, corrupt entries as misses, and a
``clear`` that never deletes the reference's entries."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import report_cache as ref_cache
from repro.core.export import load_json as ref_load_json
from repro_torch.core import export
from repro_torch.core.report_cache import (DEFAULT_ROOT, SCHEMA, ReportCache,
                                           cache_key)

FIXTURE = Path(__file__).parent / "fixtures" / "serve_report.json"
ARGS = ("serve/v1:qwen3,prompt=32,max=48", "4x2:data,model", "ring")


def test_key_is_deterministic_and_20_hex():
    key = cache_key(*ARGS)
    assert key == cache_key(*ARGS, torch.__version__, device="cuda")
    assert len(key) == 20 and int(key, 16) >= 0


@pytest.mark.parametrize("i,other", [
    (0, "serve/v2:qwen3,prompt=32,max=48"),    # builder version bumped
    (1, "2x2x2:pod,data,model"),               # another mesh
    (2, "hierarchical"),                       # another algorithm
])
def test_key_holds_config_mesh_and_algorithm(i, other):
    args = list(ARGS)
    args[i] = other
    assert cache_key(*args) != cache_key(*ARGS)


def test_key_holds_torch_version_and_capture_device():
    assert cache_key(*ARGS, "2.0.0") != cache_key(*ARGS, "2.1.0")
    # a CPU capture reshards with all-gathers where a cuda one issues
    # all-to-alls: a CPU entry must not answer a cuda sweep
    assert cache_key(*ARGS, device="cpu") != cache_key(*ARGS, device="cuda")


def test_phase_is_folded_out_of_the_key():
    assert cache_key(*ARGS, phase="decode") == cache_key(*ARGS) \
        == cache_key(*ARGS, phase="prefill")


def test_keys_differ_from_the_reference_keys():
    """The same cell never addresses a reference entry: the schema string
    (and the library version and device) are in the hash."""
    assert cache_key(*ARGS, "0.9.0") != ref_cache.cache_key(*ARGS, "0.9.0")
    assert SCHEMA != ref_cache._SCHEMA


def test_default_root_is_beside_the_reference_root():
    port, ref = Path(DEFAULT_ROOT), Path(ref_cache.DEFAULT_ROOT)
    assert port != ref and ref not in port.parents \
        and port not in ref.parents
    assert port.parent == ref.parent


def test_env_and_explicit_root(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "env"))
    assert ReportCache().root == str(tmp_path / "env")
    assert ReportCache(str(tmp_path / "x")).root == str(tmp_path / "x")
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR")
    assert ReportCache().root == DEFAULT_ROOT


def _report():
    return export.load_json(str(FIXTURE))


def test_put_get_round_trip(tmp_path):
    cache = ReportCache(str(tmp_path))
    rep = _report()
    key = cache_key(*ARGS)
    path = cache.put(key, rep, meta={"config": "serve", "mesh": "4x2"})
    assert path == cache.path_for(key) and os.path.exists(path)
    assert sorted(os.listdir(tmp_path)) == [key + ".json"]   # no tmp left
    back = cache.get(key)
    assert back.meta == {"config": "serve", "mesh": "4x2"}
    assert back.compiled_summary == rep.compiled_summary
    assert back.phase_names() == rep.phase_names()
    assert np.array_equal(back.matrix, rep.matrix)
    assert (cache.hits, cache.misses) == (1, 0)
    # the entry is a reference-shaped cache payload: the port's loaders
    # and the reference's report loader read it
    (loaded,) = export.load_json_reports(path)
    assert loaded.meta["config"] == "serve"
    assert json.loads(Path(path).read_text())["schema"] == SCHEMA


def test_phase_aware_get(tmp_path):
    cache = ReportCache(str(tmp_path))
    key = cache_key(*ARGS)
    cache.put(key, _report())
    assert cache.get(key, phase="decode").phase_names() == \
        ["prefill", "decode"]
    assert cache.get(key, phase="optim") is None
    assert (cache.hits, cache.misses) == (1, 1)


@pytest.mark.parametrize("body", ["{not json", '{"schema": "' + SCHEMA
                                  + '", "report": {"name": 1}}', "[]",
                                  json.dumps({"schema": "other", "report":
                                              json.loads(FIXTURE.read_text())
                                              })])
def test_corrupt_or_foreign_entry_is_a_miss(tmp_path, body):
    cache = ReportCache(str(tmp_path))
    key = cache_key(*ARGS)
    Path(cache.path_for(key)).write_text(body)
    assert cache.get(key) is None
    assert (cache.hits, cache.misses) == (0, 1)
    cache.put(key, _report())            # a put replaces it
    assert cache.get(key) is not None


def test_missing_entry_is_a_miss(tmp_path):
    cache = ReportCache(str(tmp_path / "none"))
    assert cache.get(cache_key(*ARGS)) is None
    assert cache.entries() == [] and cache.clear() == 0


def test_clear_keeps_the_reference_entries(tmp_path):
    """One directory holding the reference's entries, the port's and a
    corrupt file: ``clear`` removes the port's only, and the reference's
    cache still serves its entry afterwards."""
    port_cache = ReportCache(str(tmp_path))
    ref = ref_cache.ReportCache(str(tmp_path))
    ref_key = ref_cache.cache_key(*ARGS, "0.9.0")
    ref.put(ref_key, ref_load_json(str(FIXTURE)), meta={"config": "serve"})
    port_keys = [cache_key(*ARGS, device=d) for d in ("cpu", "cuda")]
    for key in port_keys:
        port_cache.put(key, _report(), meta={"config": "serve"})
    (tmp_path / "junk.json").write_text("{broken")
    entries = port_cache.entries()
    assert {e["key"] for e in entries} == {ref_key, "junk", *port_keys}
    assert [e for e in entries if e.get("corrupt")][0]["key"] == "junk"
    assert port_cache.clear() == 2
    assert sorted(os.listdir(tmp_path)) == sorted(
        [ref_key + ".json", "junk.json"])
    assert ref.get(ref_key).compiled_summary == _report().compiled_summary
    assert port_cache.get(ref_key) is None       # not a port entry
