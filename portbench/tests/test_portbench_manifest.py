"""BENCHMARK.json keeps to the benchmark's contract, and every name in
it finds its file."""
import json

import pytest

from portbench import weights
from portbench.manifest import NAME, ROOT, SOURCES, UNIT, load_reader

WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head",
               "expansion", "expand", "experts_per_tok")


def test_keys_and_names(manifest):
    raw = manifest.raw
    assert set(raw) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(raw["paths"]) <= 16 and len(raw["command"]) <= 32
    assert 1 <= raw["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in raw[k]]
    for k in ("configs", "workloads"):
        names_k = [x["name"] for x in raw[k]]
        assert len(names_k) == len(set(names_k))
    metric_names = [x["name"] for k in ("end_to_end", "per_layer")
                    for x in raw[k]]
    assert len(metric_names) == len(set(metric_names))
    for n in names:
        assert NAME.match(n), n
    for m in raw["end_to_end"] + raw["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    assert len(json.dumps(raw)) < 64 * 1024


def test_end_to_end(manifest):
    e2e = {m["name"]: m for m in manifest.raw["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in manifest.cells.values():
        got = [m.name for m in manifest.end_to_end_for(cell)]
        assert "setup_s" in got and len(got) >= 2
        assert manifest.per_layer_for(cell)


def test_budget_fits_24_cells(manifest):
    rs = manifest.raw["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


READERS = sorted(p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py"))


@pytest.mark.parametrize("name", READERS)
def test_per_layer_reader(manifest, name):
    """Each per-layer metric's reader declares a layer, a unit, a source
    and the end-to-end metric it moves; for a metric in BENCHMARK.json
    those are what the manifest says, and its cells report the metric it
    moves (the training cell's readers wait for that cell)."""
    reader = load_reader(name)
    assert UNIT.match(reader.UNIT) and reader.SOURCE in SOURCES
    assert reader.LAYER and reader.MOVES and callable(reader.read)
    listed = {m["name"]: m for m in manifest.raw["per_layer"]}
    if name in listed:
        m = listed[name]
        assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])
        for w in m["workloads"]:
            cell = manifest.cell(w)
            assert m["moves"] in [e.name
                                  for e in manifest.end_to_end_for(cell)]


def test_every_listed_metric_has_a_reader(manifest):
    assert {m["name"] for m in manifest.raw["per_layer"]} <= set(READERS)


def test_configs(manifest):
    for c in manifest.raw["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank", "_size")), k
            assert not any(w in k for w in WIDTH_WORDS), k
        assert c["file"].startswith("portbench/")
    files = [c["file"] for c in manifest.raw["configs"]]
    assert len(files) == len(set(files))


def test_every_cell_finds_its_files(manifest):
    for cell in manifest.cells.values():
        conf = manifest.config(cell)
        traffic = manifest.traffic(cell)
        limits = manifest.limits(cell)
        assert traffic["kind"] in ("closed_loop", "train")
        assert limits and all("limit" in v for v in limits.values())
        assert weights.param_count(conf) > 0
        assert cell.chips == 1 and len(cell.why) <= 200


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench" / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_param_count_matches_the_program(path):
    """The benchmark's own count of parameters, which its FLOPs use,
    agrees with the program's ``ArchConfig.param_count`` up to the final
    norm's gain, which the latter leaves out."""
    from portbench.run import arch_config
    conf = json.loads(path.read_text())
    assert (weights.param_count(conf) - conf["hidden_size"]
            == arch_config(conf).param_count())
