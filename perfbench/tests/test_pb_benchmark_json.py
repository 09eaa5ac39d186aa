"""``BENCHMARK.json`` keeps to the contract's form, and every cell's
files are found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|"
                   r"experts_per|filters)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][0] == "python3" and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        texts = ("why", "layer") + (("source",) if section == "configs" else ())
        for text in (t for t in texts if t in e):
            assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", cells):
            assert w in cells
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
        assert (ROOT / "perfbench" / "layer_metrics" / f"{m['name']}.py").is_file()
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_cells_find_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        conf = configs[w["config"]]
        used.add(conf["name"])
        assert conf["file"].startswith("perfbench/") and (ROOT / conf["file"]).is_file()
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
        mix = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench" / "modes" / f"{mix['mode']}.py").is_file()
    assert used == set(configs)
    assert len({c["file"] for c in BENCH["configs"]}) == len(configs)


def test_config_files():
    for c in BENCH["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert all(k in body for k in c["reduced"])
        assert (ROOT / "perfbench" / "reference" / f"{body['reference']}.py").is_file()


def test_paths_hold_only_named_files():
    for p in (ROOT / "perfbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
