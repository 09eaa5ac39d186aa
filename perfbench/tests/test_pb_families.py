"""A family is found by name and added as new files alone: a family
made only of files outside the repository runs as the one it copies, a
missing module or name fails naming the file, and no generic file of the
harness names a family."""

import importlib
import json
import re
import sys
from pathlib import Path

import pytest

import perfbench.programs
import perfbench.reference
from perfbench import cell, families
from perfbench.reference.train import follow
from perfbench.tests import tiny
from perfbench.tests.test_pb_dry_run import STREAM_LIMITS, TRAIN_LIMITS

HERE = Path(__file__).resolve().parents[1]
BENCH = json.loads((cell.ROOT / "BENCHMARK.json").read_text())
COPIED = "poolresnet"


def _copied_cell(mode: str) -> dict:
    """The first cell of ``mode`` whose configuration is of the copied
    family."""
    for w in BENCH["workloads"]:
        conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
        family = json.loads((cell.ROOT / conf["file"]).read_text())["family"]
        if family == COPIED and w["name"] in tiny.cells(mode):
            return w
    raise LookupError(f"no {COPIED} cell of mode {mode}")


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """-> ``BENCHMARK.json`` with a family ``toyres``, written under
    ``tmp_path`` alone: its reference and program modules re-export
    PoolResnet's, its configuration is a copy of PoolResnet's, and it has
    a cell of each of PoolResnet's cells' mixes."""
    for kind in ("reference", "programs"):
        d = tmp_path / kind
        d.mkdir()
        (d / "toyres.py").write_text(f"from perfbench.{kind}.{COPIED} import *  # noqa: F403\n")
        package = getattr(perfbench, kind)
        monkeypatch.setattr(package, "__path__", [*package.__path__, str(d)])
        monkeypatch.delitem(sys.modules, f"perfbench.{kind}.toyres", raising=False)
    importlib.invalidate_caches()
    bench = json.loads(json.dumps(BENCH))
    source = next(c for c in BENCH["configs"] if c["name"] == _copied_cell("train")["config"])
    conf = json.loads((cell.ROOT / source["file"]).read_text())
    conf.update(name="toyres", family="toyres", reference="toyres")
    (tmp_path / "toyres.json").write_text(json.dumps(conf))
    bench["configs"].append({**source, "name": "toyres", "file": str(tmp_path / "toyres.json")})
    for mode in ("train", "stream"):
        bench["workloads"].append({**_copied_cell(mode), "name": f"toyres.{mode}",
                                   "config": "toyres"})
    yield bench
    for kind in ("reference", "programs"):
        sys.modules.pop(f"perfbench.{kind}.toyres", None)


@pytest.mark.parametrize("mode", ["train", "stream"])
def test_toy_family_runs_as_its_copy(toy, mode, tmp_path):
    limits = TRAIN_LIMITS if mode == "train" else STREAM_LIMITS
    got = tiny.run(f"toyres.{mode}", limits=limits, tmp_path=tmp_path, bench=toy)
    want = tiny.run(_copied_cell(mode)["name"], limits=limits, tmp_path=tmp_path)
    assert got["correct"] and got["checks"] == want["checks"]
    assert sys.modules["perfbench.reference.toyres"].forward \
        is sys.modules[f"perfbench.reference.{COPIED}"].forward


@pytest.mark.parametrize("kind", list(families.NEEDS))
def test_a_missing_module_names_its_file(kind):
    with pytest.raises(LookupError, match=f"no perfbench/{kind}/nosuch.py"):
        families.load(kind, "nosuch")


def test_a_missing_name_names_its_file(tmp_path, monkeypatch):
    (tmp_path / "halfway.py").write_text("ROW = 5\n")
    monkeypatch.setattr(perfbench.reference, "__path__",
                        [*perfbench.reference.__path__, str(tmp_path)])
    importlib.invalidate_caches()
    try:
        with pytest.raises(LookupError, match=r"perfbench/reference/halfway\.py lacks TINY, "):
            families.load("reference", "halfway")
    finally:
        sys.modules.pop("perfbench.reference.halfway", None)


@pytest.mark.parametrize("name", ["../poolresnet", "poolresnet.nn", ""])
def test_a_name_that_is_no_module_name_is_refused(name):
    with pytest.raises(ValueError, match="not a family's module name"):
        families.load("reference", name)


def test_follow_refuses_an_optimizer_it_does_not_follow():
    c = tiny.spec(tiny.cells("train")[0]).config
    with pytest.raises(ValueError, match="not 'sgd'"):
        follow(None, c["model"], {**c["train"], "optimizer": "sgd"}, {}, (), 0)


GENERIC = [*HERE.glob("*.py"), *(HERE / "modes").glob("*.py"), *(HERE / "roofline").glob("*.py"),
           *(HERE / "reference" / n for n in ("__init__.py", "train.py", "serve.py")),
           HERE / "tests" / "tiny.py"]


@pytest.mark.parametrize("path", GENERIC, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_generic_file_names_a_family(path):
    families_named = re.compile(r'"(ssd|poolresnet)"|patch_sizes" in|reshape\([^)]*, 5\)')
    assert not families_named.findall(path.read_text())
