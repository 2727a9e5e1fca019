"""Benchmark-campaign tooling: resumable CSVs, curve writers, summarizer."""

import csv
import importlib.util
import os
import sys


def _load(name):
    scripts_dir = os.path.join(os.path.dirname(__file__), "..", "scripts")
    # scripts import their sibling _bootstrap (sys.path repair);
    # when running as `python scripts/foo.py` the dir is on sys.path —
    # mirror that here
    if scripts_dir not in sys.path:
        sys.path.insert(0, scripts_dir)
    path = os.path.join(scripts_dir, f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_quality_table_resume_set(tmp_path):
    qt = _load("quality_table")
    p = tmp_path / "t.csv"
    with open(p, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dist", "n", "id", "alg", "obj", "seconds"])
        w.writerow(["BA", "100", "0", "greedy", "271.0", "0.5"])
        w.writerow(["ER", "200", "3", "mcpg", "1845.0", "2.0"])
    done = qt.existing_rows(str(p))
    assert ("BA", 100, 0, "greedy") in done
    assert ("ER", 200, 3, "mcpg") in done
    assert ("BA", 100, 1, "greedy") not in done
    qt.append_row(str(p), "PL", 300, 7, "sa", 123.0, 4.56)
    assert ("PL", 300, 7, "sa") in qt.existing_rows(str(p))


def test_instance_wise_curve_writer_monotone(tmp_path):
    iw = _load("instance_wise")
    out = tmp_path / "iw.csv"
    with open(out, "w", newline="") as f:
        csv.writer(f).writerow(["instance", "alg", "seconds", "obj"])
    w = iw.CurveWriter(str(out), "G22like", "mcpg")
    w.add(100.0)
    w.add(90.0)  # regression: must NOT be recorded
    w.add(120.0, seconds=3.0)
    rows = list(csv.reader(open(out)))[1:]
    assert [float(r[3]) for r in rows] == [100.0, 120.0]
    assert iw.done_pairs(str(out)) == {("G22like", "mcpg")}


def test_instance_wise_instances_match_gset_shapes():
    iw = _load("instance_wise")
    g = iw.build_instance("G14like")
    assert (g.num_nodes, g.num_edges) == (800, 4694)  # G14's exact size
    assert iw.INSTANCES["G22like"][:2] == (2000, 19990)
    assert iw.INSTANCES["G70like"][:2] == (10000, 9999)
